// K2: voxel-occupancy hit accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel coma_tpu/ops/occupancy_kernel.py:77
// occupancy_accumulate_padded (pallas_call :112; body _occupancy_kernel :44;
// driver fused_occupancy_update_batch :133). Its plain version is
// coma_tpu_torch/affordance/occupancy.py occupancy_update_batch; the wrapper
// and the cull's emulation are coma_tpu_torch/ops/occupancy_kernel.py.
//
// What it computes. For a slab of S samples with validity v_s, with
// x = human vertex - anchor (the anchor is the object vertex
// selected_obj_idx, subtracted by the wrapper), add 1 into acc[h, l] for
// each valid sample with ||g_l||^2 - 2 g_l.x + ||x||^2 < thres^2, g_l being
// voxel l's centre. ||x||^2 and ||g||^2 come from the wrapper, computed by
// the same PyTorch expressions as in the plain version. The anchor carried
// out (the last valid sample's) is set by the wrapper.
//
// What bounds it on the H100. The accumulator, H*L*4 bytes (1.13 GB at
// H=10475, L=30^3), read and written once per slab, would be 2.26 GB, 0.67 ms
// at 3.35 TB/s; the dense tests, nine FP32 operations per (element, valid
// sample), would take 1.2 ms at a slab of 32. But the threshold is 3 voxels
// and a vertex lies that close to few of the grid's bricks, so the cull below
// leaves a few percent of the tests, and only the (vertex, brick) rows of the
// accumulator with a kept pair are read and written: the kernel is bound by
// the bytes of those rows.
//
// Design. A block owns a brick of voxels, kPerThread slices of the slowest
// axis by bj rows of the middle one by the whole fastest axis (bj = 128 / R
// rows, so that the bj * R voxels of a slice are one contiguous run, one per
// thread: every warp load is whole and coalesced), and a tile of kTileH
// human vertices. Each thread holds its kPerThread voxels' centres in
// registers. The block first reduces its voxel centres to a box and the
// largest ||g||^2, then stages each (h, s) pair (rows along the threads, so
// the loads of x are coalesced) as a float4 (2x, ||x||^2) in shared memory
// and keeps, as a bit per sample and row, only the valid
// pairs whose squared distance to the box is at most
// thres^2 + margin * (||x||^2 + max ||g||^2 + thres^2): a pair it drops has
// every rounded d^2 above thres^2, since the rounding of d^2 is below
// 2^-20 (||x||^2 + ||g||^2) and margin is 2^-17. A NaN distance is kept.
// The loop over the kept bits is block-uniform. Each accumulator element of
// a row with a kept pair is read once, gets its tests in registers and is
// written once: no atomics. A row without one would only add zeros, so it is
// neither read nor written (block-uniform too).
// The cross term and d^2 are rounded in the plain version's order,
// ((x0 g0 + x1 g1) + x2 g2) and (||g||^2 - 2 cross) + ||x||^2; with x
// pre-scaled by 2 (exact) the cross term is 2 cross already, so the hit
// counts equal the plain version's (for every input where no x_i g_i
// underflows to a subnormal).

#include <cuda_runtime.h>

namespace {

// The launcher refuses a caller whose brick layout (threads per block,
// slices per brick) is not this one.
constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 16;
constexpr int kRows = 4;         // rows whose accumulators are in flight together
constexpr int kMaxSlab = 64;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o /= 2) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads) occupancy_hits_kernel(
    float* __restrict__ acc,          // (H, L)
    const float* __restrict__ x,      // (S, H, 3) anchored human vertices
    const float* __restrict__ xsq,    // (S, H) ||x||^2
    const float* __restrict__ grid,   // (3, L) voxel centres
    const float* __restrict__ gsq,    // (L,) ||g||^2
    const float* __restrict__ valid,  // (S,)
    int S, int H, int R, int bj, int n_bj, float thres_sq, float margin) {
  __shared__ float4 xs[kTileH][kMaxSlab];         // 2 x0, 2 x1, 2 x2, ||x||^2
  __shared__ unsigned char flag[kTileH][kMaxSlab];
  __shared__ unsigned keep[kTileH][2];            // kept samples per row, 32 per word
  __shared__ float part[kWarps][7];
  __shared__ float box[7];                        // lo xyz, hi xyz, max ||g||^2

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int i0 = blockIdx.x / n_bj * kPerThread;
  const int j = blockIdx.x % n_bj * bj + t / R;
  const bool col = t < bj * R && j < R;
  const size_t RR = (size_t)R * R, L = RR * R;
  const size_t l0 = (size_t)j * R + t % R;        // within a slice of the slowest axis

  float gx[kPerThread], gy[kPerThread], gz[kPerThread], g2[kPerThread];
  bool in[kPerThread];
  float lo0 = INFINITY, lo1 = INFINITY, lo2 = INFINITY;
  float hi0 = -INFINITY, hi1 = -INFINITY, hi2 = -INFINITY, g2max = 0.0f;
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    in[v] = col && i0 + v < R;
    const size_t l = in[v] ? (i0 + v) * RR + l0 : 0;
    gx[v] = grid[l];
    gy[v] = grid[L + l];
    gz[v] = grid[2 * L + l];
    g2[v] = gsq[l];
    if (in[v]) {
      lo0 = fminf(lo0, gx[v]); lo1 = fminf(lo1, gy[v]); lo2 = fminf(lo2, gz[v]);
      hi0 = fmaxf(hi0, gx[v]); hi1 = fmaxf(hi1, gy[v]); hi2 = fmaxf(hi2, gz[v]);
      g2max = fmaxf(g2max, g2[v]);
    }
  }
  lo0 = warp_min(lo0); lo1 = warp_min(lo1); lo2 = warp_min(lo2);
  hi0 = warp_max(hi0); hi1 = warp_max(hi1); hi2 = warp_max(hi2); g2max = warp_max(g2max);
  if (lane == 0) {
    part[warp][0] = lo0; part[warp][1] = lo1; part[warp][2] = lo2;
    part[warp][3] = hi0; part[warp][4] = hi1; part[warp][5] = hi2; part[warp][6] = g2max;
  }
  __syncthreads();
  if (t < 7) {
    float r = part[0][t];
    for (int w = 1; w < kWarps; ++w) r = t < 3 ? fminf(r, part[w][t]) : fmaxf(r, part[w][t]);
    box[t] = r;
  }
  __syncthreads();

  // Stage the tile's pairs, rows along the threads, and flag those that can
  // hit the brick; then one ballot per row and 32 samples.
  const int h0 = blockIdx.y * kTileH;
  const int th = min(kTileH, H - h0);
  const float blo0 = box[0], blo1 = box[1], blo2 = box[2];
  const float bhi0 = box[3], bhi1 = box[4], bhi2 = box[5], bg2 = box[6];
#pragma unroll 4
  for (int p = t; p < kTileH * S; p += kThreads) {
    const int r = p % kTileH, s = p / kTileH;
    bool kept = false;
    if (r < th) {
      const size_t q = (size_t)s * H + h0 + r;
      const float x0 = x[3 * q], x1 = x[3 * q + 1], x2 = x[3 * q + 2], x_sq = xsq[q];
      xs[r][s] = make_float4(2.0f * x0, 2.0f * x1, 2.0f * x2, x_sq);
      const float d0 = fmaxf(fmaxf(blo0 - x0, x0 - bhi0), 0.0f);
      const float d1 = fmaxf(fmaxf(blo1 - x1, x1 - bhi1), 0.0f);
      const float d2 = fmaxf(fmaxf(blo2 - x2, x2 - bhi2), 0.0f);
      const float dist2 = d0 * d0 + d1 * d1 + d2 * d2;
      const float limit = thres_sq + margin * (x_sq + bg2 + thres_sq);
      kept = valid[s] > 0.0f && !(dist2 > limit);
    }
    flag[r][s] = kept;
  }
  __syncthreads();
  for (int r = warp; r < kTileH; r += kWarps) {
    for (int half = 0; half < 2; ++half) {
      const int s = half * 32 + lane;
      const unsigned m = __ballot_sync(0xffffffffu, s < S && flag[r][s]);
      if (lane == 0) keep[r][half] = m;
    }
  }
  __syncthreads();

  // kRows rows at a time: their accumulators are loaded together, so each
  // thread keeps kRows * kPerThread loads in flight. A row is live if it has
  // a kept pair (rows past th have none).
  for (int r0 = 0; r0 < th; r0 += kRows) {
    float a[kRows][kPerThread];
    bool live[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      live[rr] = (keep[r0 + rr][0] | keep[r0 + rr][1]) != 0u;
      const size_t row = (size_t)(h0 + r0 + rr) * L + l0;
#pragma unroll
      for (int v = 0; v < kPerThread; ++v)
        a[rr][v] = live[rr] && in[v] ? acc[row + (i0 + v) * RR] : 0.0f;
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = r0 + rr;
      if (r >= th) break;
      for (int half = 0; half < 2; ++half) {
        for (unsigned m = keep[r][half]; m != 0; m &= m - 1) {
          const float4 xv = xs[r][half * 32 + __ffs(m) - 1];
#pragma unroll
          for (int v = 0; v < kPerThread; ++v) {
            const float cross2 = __fadd_rn(
                __fadd_rn(__fmul_rn(xv.x, gx[v]), __fmul_rn(xv.y, gy[v])), __fmul_rn(xv.z, gz[v]));
            const float d_sq = __fadd_rn(__fsub_rn(g2[v], cross2), xv.w);
            a[rr][v] += d_sq < thres_sq ? 1.0f : 0.0f;
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const size_t row = (size_t)(h0 + r0 + rr) * L + l0;
#pragma unroll
      for (int v = 0; v < kPerThread; ++v)
        if (live[rr] && in[v]) acc[row + (i0 + v) * RR] = a[rr][v];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success), which
// also reports a grid size the card refuses. `threads` and `brick_i` are the
// caller's brick layout, which must be the kernel's.
int coma_occupancy_hits(float* acc, const float* x, const float* xsq, const float* grid,
                        const float* gsq, const float* valid, int S, int H, int R,
                        int threads, int brick_i, float thres_sq, float margin, void* stream) {
  if (threads != kThreads || brick_i != kPerThread || S < 1 || S > kMaxSlab || R < 1 ||
      R > kThreads)
    return (int)cudaErrorInvalidValue;
  const int bj = kThreads / R;
  const int n_bj = (R + bj - 1) / bj, n_bi = (R + kPerThread - 1) / kPerThread;
  const dim3 blocks(n_bi * n_bj, (H + kTileH - 1) / kTileH);
  occupancy_hits_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      acc, x, xsq, grid, gsq, valid, S, H, R, bj, n_bj, thres_sq, margin);
  return (int)cudaGetLastError();
}

const char* coma_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
