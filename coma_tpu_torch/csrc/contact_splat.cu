// K1: canonicalise + geodesic-Gaussian splat + accumulate, for Hopper (sm_90a).
//
// Replaces the TPU kernel coma_tpu/ops/contact_kernel.py:405
// canon_splat_accumulate_padded (pallas_call :459; body _canon_splat_kernel
// :257 and _splat_lane_chunks :323; driver fused_contact_update_batch :111).
// Its plain version is coma_tpu_torch/affordance/contact.py
// contact_update_batch; the wrapper and the splat plan are
// coma_tpu_torch/ops/contact_kernel.py.
//
// What it computes. For a slab of S samples with validity v_s and every pair
// (h, o): normalise both normals, canonicalise both ways (Rodrigues R(b->p)a,
// or a 180 degree turn about q where 1 + b.p < eps, then renormalise), and for
// each of the N sphere directions g add the splat of the canonical direction c
// into ph[h, o, n] (human wrt object) and po[h, o, n] (object wrt human). The
// (H, O) sums are fused in: nom += exp(-d/size), sig += (d < thres),
// den += v_s, with d the vertex distance. Samples with v_s <= 0 add nothing
// to the sums (they are skipped, never multiplied by 0: NaN * 0 is NaN).
// Division by size and by sigma^2 is a multiply by their float reciprocals,
// as PyTorch divides a CUDA tensor by a Python scalar.
//
// The splat, by route (chosen by sigma alone, in the plan):
//  - polynomial (the TPU kernel's, where the Gaussian reaches the 1e-8
//    cutoff before the antipode): t = 1 - c.g as three fused multiply-adds,
//    six Horner steps of the fitted theta^2(t) with -log2(e)/sigma^2 folded
//    into the coefficients, one ex2.approx on the SFU, and 0 where t > t_max
//    or t is NaN. The plain version's exact splat differs from it by at most
//    ~3e-7 per splat (the fit, tests/test_torch_splat_plan.py);
//  - exact: exp(-arccos(clip(c.g))^2 / sigma^2) with the accurate acosf and
//    expf, the dot product rounded in the plain version's order.
// The canonicalization is rounded after every operation, in the plain
// version's order, on both routes: its singular branch (1 + b.p -> 0)
// amplifies any last-bit difference into visible splat differences.
//
// What bounds it on the H100. Per sample it is 2*H*O*N splats (0.94 G at
// the qual shape 10475 x 180 x 250). The accumulators, 2*H*O*N*4 bytes
// (3.77 GB at the qual shape), are read and written once per slab: 7.5 GB,
// 2.3 ms at 3.35 TB/s. At a slab of 32 samples the splats (30 G, 13
// instructions each on the polynomial route: 3 for t, the clamp, 6 Horner
// steps, ex2, the compare and the predicated add) take longer than that, so
// the kernel is bound by instruction issue, not by HBM.
//
// Design. Natural (H, O, N) layout, no transpose, no padding. One block of
// 8 warps per (h, tile of kTileO object vertices); a warp per (direction, o)
// row of the tile. The plan splits the N grid points into kPatches patches
// of <= 32 nearby points, and lane l holds point l of every patch in
// registers, so a row's accumulators are kPatches registers per lane, read
// once per slab and written once. The block first lists the slab's valid
// samples (a warp ballot) and computes, for each valid sample and object
// vertex of the tile, both canonical directions, the distance terms and, per
// direction, a bit mask of the patches it may reach (plan: c.u_w >=
// cos_reach_w), into shared memory as float4 (cx, cy, cz, mask bits): they
// do not depend on n. A warp then runs over the valid samples in order; each
// broadcast float4 feeds kPatches splats per lane (one shared-memory load per
// 8 splats), and the warp skips patch w where bit w is clear. The bits are
// the same on all 32 lanes, so the branch is warp-uniform, and every splat
// skipped is one the polynomial route sets to 0 (the plan's threshold is
// conservative against the float32 tests). Every element has exactly one
// owner: no atomics, and the sums run in sample order, as in the plain
// version. The (H, O) sums are owned by one thread per o.

#include <cuda_runtime.h>

namespace {

// The launcher refuses a plan whose patch size is not kLanes, a slab over
// kMaxSlab and more than kPatches patches.
constexpr int kLanes = 32;     // grid points per patch
constexpr int kPatches = 8;    // at most; a lane holds one point of each
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kTileO = 8;
constexpr int kMaxSlab = 64;

struct V3 {
  float x, y, z;
};

// theta^2 fit times -log2(e)/sigma^2, ascending, and the cutoff on t.
struct Poly {
  float c[7];
  float t_max;
};

// Arithmetic rounded after every operation (no fused multiply-add), so the
// kernel's canonicalization rounds exactly as the plain version's separate
// PyTorch operations do.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// ((a.x b.x + a.y b.y) + a.z b.z)
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p) { return {p[0], p[1], p[2]}; }

// v / max(|v|, eps): a zero vector stays zero.
__device__ __forceinline__ V3 normalized(V3 v, float eps) {
  const float n = fmaxf(sqrtf(dot3(v, v)), eps);
  return {__fdiv_rn(v.x, n), __fdiv_rn(v.y, n), __fdiv_rn(v.z, n)};
}

// R(b -> p) a for unit a, b, renormalised:
//   ((a.w w) / (1+c) + c a + (a.b) p) - (a.p) b  with c = b.p, w = b x p,
// or the 180 degree turn about q, (2 a.q) q - a, where 1 + c < eps.
__device__ V3 canonicalize(V3 a, V3 b, V3 p, V3 q, float eps) {
  const float c = dot3(b, p);
  V3 out;
  if (add(1.0f, c) < eps) {
    const float t = mul(2.0f, dot3(a, q));
    out = {sub(mul(t, q.x), a.x), sub(mul(t, q.y), a.y), sub(mul(t, q.z), a.z)};
  } else {
    const V3 w = {sub(mul(b.y, p.z), mul(b.z, p.y)), sub(mul(b.z, p.x), mul(b.x, p.z)),
                  sub(mul(b.x, p.y), mul(b.y, p.x))};
    const float inv = __frcp_rn(add(1.0f, c));
    const float adw = dot3(a, w), adb = dot3(a, b), adp = dot3(a, p);
    out = {sub(add(add(mul(mul(adw, w.x), inv), mul(c, a.x)), mul(adb, p.x)), mul(adp, b.x)),
           sub(add(add(mul(mul(adw, w.y), inv), mul(c, a.y)), mul(adb, p.y)), mul(adp, b.y)),
           sub(add(add(mul(mul(adw, w.z), inv), mul(c, a.z)), mul(adb, p.z)), mul(adp, b.z))};
  }
  return normalized(out, eps);
}

// Bit w set where direction c may reach patch w inside the cutoff; every
// patch's bit for a direction that is not unit (zero, NaN).
__device__ __forceinline__ unsigned reach_mask(V3 c, const float4* __restrict__ patch, int P,
                                               float unit_tol) {
  const float r2 = c.x * c.x + c.y * c.y + c.z * c.z;
  if (!(fabsf(r2 - 1.0f) <= unit_tol)) return (1u << P) - 1u;
  unsigned m = 0;
  for (int w = 0; w < P; ++w) {
    const float4 u = patch[w];
    if (c.x * u.x + c.y * u.y + c.z * u.z >= u.w) m |= 1u << w;
  }
  return m;
}

// volatile: the compiler may not sink it, with the Horner steps, into a
// branch on t <= t_max, which diverges across the warp's lanes.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Polynomial route: acc += exp(-theta^2(t)/sigma^2) where t = 1 - c.g <= t_max
// (not NaN), computed on every lane, the add predicated.
__device__ __forceinline__ void add_splat_poly(float& acc, float4 c, float4 g, const Poly& k,
                                               float eps) {
  const float t = fmaf(-c.z, g.z, fmaf(-c.y, g.y, fmaf(-c.x, g.x, 1.0f)));
  const float tc = fmaxf(t, eps);
  float p = k.c[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) p = fmaf(p, tc, k.c[i]);
  const float e = ex2_approx(p);
  if (t <= k.t_max) acc += e;
}

// Exact route: ((c.x g.x + c.y g.y) + c.z g.z), clipped, arccos, Gaussian.
__device__ __forceinline__ float splat_exact(float4 c, float4 g, float lo, float hi,
                                             float inv_s2) {
  const float cosv = add(add(mul(c.x, g.x), mul(c.y, g.y)), mul(c.z, g.z));
  const float a = acosf(fminf(fmaxf(cosv, lo), hi));
  return expf(-(a * a) * inv_s2);
}

// The polynomial route's branchy loop has one dependent chain per splat, so
// it asks for 4 blocks (32 warps) per SM: 64 registers, with a few bytes
// spilled (ptxas reports them at build); the exact route interleaves 8
// splats per sample and keeps more registers.
template <bool kPoly>
__global__ void __launch_bounds__(kThreads, kPoly ? 4 : 1) contact_splat_kernel(
    float* __restrict__ ph, float* __restrict__ po,           // (H, O, N)
    float* __restrict__ nom, float* __restrict__ den,         // (H, O)
    float* __restrict__ sig,                                  // (H, O)
    const float* __restrict__ hv, const float* __restrict__ hn,  // (S, H, 3)
    const float* __restrict__ ov, const float* __restrict__ on,  // (S, O, 3)
    const float* __restrict__ valid,                          // (S,)
    const float4* __restrict__ slots,    // (P*32,) grid point xyz, index as int bits (-1: none)
    const float4* __restrict__ patches,  // (P,) unit centre, cos_reach
    const float* __restrict__ pq,        // (6,) unit p, q
    int S, int H, int O, int N, int P, int n_otiles,
    float inv_size, float grid_thres, float inv_s2, float lo, float hi, float eps,
    float unit_tol, Poly poly) {
  extern __shared__ float4 smem4[];
  float4* patch_s = smem4;                                   // [kPatches]
  float4* canon = patch_s + kPatches;                        // [2][kTileO][S]: xyz, mask bits
  float* prox_s = reinterpret_cast<float*>(canon + 2 * kTileO * S);  // [S][kTileO]
  float* sig_s = prox_s + S * kTileO;                        // [S][kTileO]
  float* v_s = sig_s + S * kTileO;                           // [S]
  int* list = reinterpret_cast<int*>(v_s + S);               // [S] valid samples, in order
  __shared__ int n_valid;

  const int h = blockIdx.x / n_otiles;
  const int o0 = (blockIdx.x % n_otiles) * kTileO;
  const int to = min(kTileO, O - o0);
  // from lane 0, so that the compiler knows it is the same across the warp
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / kLanes, 0);
  const int lane = threadIdx.x % kLanes;

  // Lane l holds point l of every patch. A warp per (direction, o) row of
  // the tile: row r is (0, r) for r < to, (1, r - to) after. The warp's first
  // row of accumulators is loaded now, in flight while the block
  // canonicalises.
  float4 g[kPatches];
  int n[kPatches];
#pragma unroll
  for (int w = 0; w < kPatches; ++w) {
    g[w] = w < P ? slots[w * kLanes + lane] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    n[w] = w < P ? __float_as_int(g[w].w) : -1;
  }
  auto row_of = [&](int r) {
    const int dir = r < to ? 0 : 1, ol = r < to ? r : r - to;
    return (dir == 0 ? ph : po) + ((size_t)h * O + o0 + ol) * N;
  };
  float first[kPatches];
  if (warp < 2 * to) {
    const float* row = row_of(warp);
#pragma unroll
    for (int w = 0; w < kPatches; ++w) first[w] = n[w] >= 0 ? row[n[w]] : 0.0f;
  }

  if (warp == 0) {
    int count = 0;
    for (int s0 = 0; s0 < S; s0 += kLanes) {
      const int s = s0 + lane;
      const float v = s < S ? valid[s] : 0.0f;
      if (s < S) v_s[s] = v;
      const unsigned m = __ballot_sync(0xffffffffu, v > 0.0f);
      if (v > 0.0f) list[count + __popc(m & ((1u << lane) - 1u))] = s;
      count += __popc(m);
    }
    if (lane == 0) n_valid = count;
  }
  if (threadIdx.x < P) patch_s[threadIdx.x] = patches[threadIdx.x];
  __syncthreads();
  const int nv = n_valid;

  const V3 p = load3(pq), q = load3(pq + 3);
  for (int i = threadIdx.x; i < nv * kTileO; i += kThreads) {
    const int j = i / kTileO, ol = i % kTileO;
    if (ol >= to) continue;
    const int s = list[j];
    const size_t hi3 = ((size_t)s * H + h) * 3, oi3 = ((size_t)s * O + o0 + ol) * 3;
    const V3 diff = {sub(hv[hi3], ov[oi3]), sub(hv[hi3 + 1], ov[oi3 + 1]),
                     sub(hv[hi3 + 2], ov[oi3 + 2])};
    const float d = sqrtf(dot3(diff, diff));
    prox_s[i] = expf(mul(-d, inv_size));
    sig_s[i] = d < grid_thres ? 1.0f : 0.0f;
    const V3 a = normalized(load3(hn + hi3), eps), b = normalized(load3(on + oi3), eps);
    const V3 ch = canonicalize(a, b, p, q, eps);  // human wrt object
    const V3 co = canonicalize(b, a, p, q, eps);  // object wrt human
    const unsigned mh = kPoly ? reach_mask(ch, patch_s, P, unit_tol) : 0u;
    const unsigned mo = kPoly ? reach_mask(co, patch_s, P, unit_tol) : 0u;
    canon[ol * S + j] = make_float4(ch.x, ch.y, ch.z, __uint_as_float(mh));
    canon[(kTileO + ol) * S + j] = make_float4(co.x, co.y, co.z, __uint_as_float(mo));
  }
  __syncthreads();

  if (threadIdx.x < to) {
    const int ol = threadIdx.x;
    const size_t ho = (size_t)h * O + o0 + ol;
    float a_nom = nom[ho], a_den = den[ho], a_sig = sig[ho];
    for (int j = 0; j < nv; ++j) {
      a_nom += prox_s[j * kTileO + ol];
      a_sig += sig_s[j * kTileO + ol];
    }
    for (int s = 0; s < S; ++s) a_den += v_s[s];
    nom[ho] = a_nom;
    den[ho] = a_den;
    sig[ho] = a_sig;
  }

  for (int r = warp; r < 2 * to; r += kWarps) {
    float acc[kPatches];
    if (r == warp) {
#pragma unroll
      for (int w = 0; w < kPatches; ++w) acc[w] = first[w];
    } else {
      const float* row = row_of(r);
#pragma unroll
      for (int w = 0; w < kPatches; ++w) acc[w] = n[w] >= 0 ? row[n[w]] : 0.0f;
    }
    const int dir = r < to ? 0 : 1, ol = r < to ? r : r - to;
    const float4* c_row = canon + (dir * kTileO + ol) * S;
    for (int j = 0; j < nv; ++j) {
      const float4 c = c_row[j];
      const unsigned bits = __float_as_uint(c.w);
#pragma unroll
      for (int w = 0; w < kPatches; ++w) {
        if (!kPoly) {
          acc[w] += splat_exact(c, g[w], lo, hi, inv_s2);
        } else if ((bits >> w) & 1u) {
          add_splat_poly(acc[w], c, g[w], poly, eps);
        }
      }
    }
    float* row = row_of(r);
#pragma unroll
    for (int w = 0; w < kPatches; ++w)
      if (n[w] >= 0) row[n[w]] = acc[w];
  }
}

// Dynamic shared memory for a slab of S samples: 9.5 KB at S = 32, 18.8 KB
// at S = kMaxSlab, under the 48 KB a launch gets without opting in.
int smem_bytes(int S) {
  return (kPatches + 2 * kTileO * S) * (int)sizeof(float4) +
         (2 * S * kTileO + S) * (int)sizeof(float) + S * (int)sizeof(int);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success), which
// also reports a grid or shared-memory size the card refuses. `poly` holds
// the seven coefficients and t_max of the polynomial route (warps skip the
// patches a direction cannot reach); null selects the exact route. `lanes`
// is the plan's patch size.
int coma_contact_splat(float* ph, float* po, float* nom, float* den, float* sig,
                       const float* hv, const float* hn, const float* ov, const float* on,
                       const float* valid, const float* slots, const float* patches,
                       const float* pq, int S, int H, int O, int N, int P, int lanes,
                       float inv_size, float grid_thres, float inv_s2, float lo, float hi,
                       float eps, float unit_tol, const float* poly, void* stream) {
  if (lanes != kLanes || P < 1 || P > kPatches || N > P * kLanes || S < 1 || S > kMaxSlab)
    return (int)cudaErrorInvalidValue;
  Poly k = {};
  if (poly != nullptr) {
    for (int i = 0; i < 7; ++i) k.c[i] = poly[i];
    k.t_max = poly[7];
  }
  const int n_otiles = (O + kTileO - 1) / kTileO;
  const long long blocks = (long long)H * n_otiles;
  const float4* sl = reinterpret_cast<const float4*>(slots);
  const float4* pa = reinterpret_cast<const float4*>(patches);
  const int smem = smem_bytes(S);
  auto launch = [&](auto kernel) {
    kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        ph, po, nom, den, sig, hv, hn, ov, on, valid, sl, pa, pq, S, H, O, N, P, n_otiles,
        inv_size, grid_thres, inv_s2, lo, hi, eps, unit_tol, k);
  };
  if (poly != nullptr) {
    launch(contact_splat_kernel<true>);
  } else {
    launch(contact_splat_kernel<false>);
  }
  return (int)cudaGetLastError();
}

const char* coma_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
