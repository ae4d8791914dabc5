// Native (C++) hot utilities for the coma_tpu runtime.
//
// Reference parity: the native functionality the reference reaches through
// dependencies (SURVEY.md §2.5):
//   - poisson_eliminate: Open3D's C++ sample_points_poisson_disk core
//     (Yuksel weighted sample elimination) used by the downsample stages.
//   - points_inside_mesh: the point-in-mesh primitive behind the
//     mesh-boolean intersection volume (the reference shells out to
//     Blender's C++ boolean per sample, compute_metrics.py:86-99).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Single-threaded by design: callers parallelize across assets/samples.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Weighted sample elimination (Yuksel 2015), matching the semantics of
// coma_tpu/geometry/sampling.py::poisson_disk_eliminate.
// pts: (m, 3) float64. Writes up to m flags into keep_out (1 = kept).
// Returns the number of kept points (== n_target) or -1 on error.
// ---------------------------------------------------------------------------
int poisson_eliminate(const double* pts, int m, int n_target, double total_area,
                      uint8_t* keep_out) {
  if (n_target > m || m <= 0) return -1;
  const double r_max = std::sqrt(total_area / (2.0 * std::sqrt(3.0) * n_target));
  const double radius = 2.0 * r_max;

  // spatial hash grid with cell size = radius
  double lo[3] = {pts[0], pts[1], pts[2]};
  double hi[3] = {pts[0], pts[1], pts[2]};
  for (int i = 1; i < m; ++i)
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], pts[3 * i + k]);
      hi[k] = std::max(hi[k], pts[3 * i + k]);
    }
  int dims[3];
  for (int k = 0; k < 3; ++k) {
    dims[k] = std::max(1, (int)std::floor((hi[k] - lo[k]) / radius) + 1);
    dims[k] = std::min(dims[k], 512);
  }
  auto cell_of = [&](const double* p, int* c) {
    for (int k = 0; k < 3; ++k) {
      int v = (int)((p[k] - lo[k]) / radius);
      c[k] = std::min(std::max(v, 0), dims[k] - 1);
    }
  };
  const long n_cells = (long)dims[0] * dims[1] * dims[2];
  std::vector<std::vector<int>> grid(n_cells);
  for (int i = 0; i < m; ++i) {
    int c[3];
    cell_of(pts + 3 * i, c);
    grid[(long)c[0] * dims[1] * dims[2] + (long)c[1] * dims[2] + c[2]].push_back(i);
  }

  auto weight_fn = [&](double d) {
    double t = 1.0 - d / radius;
    double t2 = t * t;
    return t2 * t2 * t2 * t2;  // (1 - d/r)^8
  };

  // neighbor lists within `radius`
  std::vector<std::vector<int>> neighbors(m);
  std::vector<double> weights(m, 0.0);
  for (int i = 0; i < m; ++i) {
    int c[3];
    cell_of(pts + 3 * i, c);
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          int cx = c[0] + dx, cy = c[1] + dy, cz = c[2] + dz;
          if (cx < 0 || cy < 0 || cz < 0 || cx >= dims[0] || cy >= dims[1] ||
              cz >= dims[2])
            continue;
          for (int j : grid[(long)cx * dims[1] * dims[2] + (long)cy * dims[2] + cz]) {
            if (j == i) continue;
            double d2 = 0.0;
            for (int k = 0; k < 3; ++k) {
              double dd = pts[3 * i + k] - pts[3 * j + k];
              d2 += dd * dd;
            }
            if (d2 < radius * radius) {
              neighbors[i].push_back(j);
              weights[i] += weight_fn(std::sqrt(d2));
            }
          }
        }
  }

  // lazy-deletion max-heap on weights
  using Entry = std::pair<double, int>;
  std::priority_queue<Entry> heap;
  for (int i = 0; i < m; ++i) heap.push({weights[i], i});
  std::vector<uint8_t> alive(m, 1);
  int n_alive = m;
  while (n_alive > n_target && !heap.empty()) {
    auto [w, i] = heap.top();
    heap.pop();
    if (!alive[i]) continue;
    if (w != weights[i]) {  // stale entry
      heap.push({weights[i], i});
      continue;
    }
    alive[i] = 0;
    --n_alive;
    for (int j : neighbors[i]) {
      if (!alive[j]) continue;
      double d2 = 0.0;
      for (int k = 0; k < 3; ++k) {
        double dd = pts[3 * i + k] - pts[3 * j + k];
        d2 += dd * dd;
      }
      weights[j] -= weight_fn(std::sqrt(d2));
      heap.push({weights[j], j});
    }
  }
  std::memcpy(keep_out, alive.data(), m);
  return n_alive;
}

// ---------------------------------------------------------------------------
// Point-in-mesh via +z ray-crossing parity with an xy-bucketed triangle grid.
// pts (P, 3), verts (V, 3), faces (F, 3) int32. out (P,) uint8.
// ---------------------------------------------------------------------------
void points_inside_mesh(const double* pts, int P, const double* verts, int V,
                        const int32_t* faces, int F, uint8_t* out) {
  // xy bounds of the mesh
  double lo[2] = {verts[0], verts[1]}, hi[2] = {verts[0], verts[1]};
  for (int i = 1; i < V; ++i)
    for (int k = 0; k < 2; ++k) {
      lo[k] = std::min(lo[k], verts[3 * i + k]);
      hi[k] = std::max(hi[k], verts[3 * i + k]);
    }
  const int G = 64;
  double sx = (hi[0] - lo[0]) / G + 1e-12, sy = (hi[1] - lo[1]) / G + 1e-12;
  std::vector<std::vector<int>> buckets(G * G);
  for (int f = 0; f < F; ++f) {
    double bxmin = 1e300, bxmax = -1e300, bymin = 1e300, bymax = -1e300;
    for (int k = 0; k < 3; ++k) {
      const double* v = verts + 3 * faces[3 * f + k];
      bxmin = std::min(bxmin, v[0]);
      bxmax = std::max(bxmax, v[0]);
      bymin = std::min(bymin, v[1]);
      bymax = std::max(bymax, v[1]);
    }
    int x0 = std::min(std::max((int)((bxmin - lo[0]) / sx), 0), G - 1);
    int x1 = std::min(std::max((int)((bxmax - lo[0]) / sx), 0), G - 1);
    int y0 = std::min(std::max((int)((bymin - lo[1]) / sy), 0), G - 1);
    int y1 = std::min(std::max((int)((bymax - lo[1]) / sy), 0), G - 1);
    for (int x = x0; x <= x1; ++x)
      for (int y = y0; y <= y1; ++y) buckets[x * G + y].push_back(f);
  }

  // tiny irrational xy nudge (shared-edge double-count guard, matching
  // coma_tpu/lifting/metrics.py::points_inside_mesh)
  const double ex = 7.3e-6, ey = 3.1e-6;
  for (int p = 0; p < P; ++p) {
    double px = pts[3 * p] + ex, py = pts[3 * p + 1] + ey, pz = pts[3 * p + 2];
    int crossings = 0;
    if (px >= lo[0] && px <= hi[0] && py >= lo[1] && py <= hi[1]) {
      int bx = std::min(std::max((int)((px - lo[0]) / sx), 0), G - 1);
      int by = std::min(std::max((int)((py - lo[1]) / sy), 0), G - 1);
      for (int f : buckets[bx * G + by]) {
        const double* v0 = verts + 3 * faces[3 * f];
        const double* v1 = verts + 3 * faces[3 * f + 1];
        const double* v2 = verts + 3 * faces[3 * f + 2];
        double e0x = v1[0] - v0[0], e0y = v1[1] - v0[1];
        double e1x = v2[0] - v0[0], e1y = v2[1] - v0[1];
        double denom = e0x * e1y - e0y * e1x;
        if (std::fabs(denom) < 1e-12) continue;
        double dx = px - v0[0], dy = py - v0[1];
        double u = (dx * e1y - dy * e1x) / denom;
        double w = (e0x * dy - e0y * dx) / denom;
        if (u < 0 || w < 0 || u + w > 1) continue;
        double z = v0[2] + u * (v1[2] - v0[2]) + w * (v2[2] - v0[2]);
        if (z > pz) ++crossings;
      }
    }
    out[p] = (uint8_t)(crossings & 1);
  }
}

}  // extern "C"
