// K3 in float32: scaled dot-product attention, softmax(Q K^T / sqrt(D)) V,
// non-causal, for Hopper (sm_90a), on the FP32 pipes.
//
// Replaces, for float32, the TPU route of coma_tpu/ops/attention.py:41
// scaled_dot_attention, which calls the JAX library's Pallas flash_attention
// (:44-59) when Lq == Lk >= 1024, L % 512 == 0 and D % 128 == 0, and XLA's
// einsum chain (_xla_attention, :17) otherwise. Its plain version is
// coma_tpu_torch/ops/attention.py attention_reference; the wrapper is
// coma_tpu_torch/ops/attention.py scaled_dot_attention, which sends every
// float32 call here and every bf16 call to flash_attention_sm90.cu (the
// tensor-core kernel). Float32 reaches this kernel from a UNet or VAE built
// in float32 (the library's default), the tiny 64x64 loop and the tests.
//
// What it computes. For one (batch, head) slice, q (Lq, D), k and v (Lk, D),
// all contiguous float: o = softmax(q k^T / sqrt(D)) v. Every product, the
// running max and sum, and the output accumulator are fp32, on FFMA: no TF32.
//
// What bounds it on the H100. 4 Lq Lk D operations per slice against
// 8 (Lq + Lk) D bytes: at (8, 8, 1024, 1024, 80) 0.32 ms at the 67 TFLOP/s
// FP32 rate against 0.025 ms of memory traffic, so operations bound it. The
// FP32 rate is one FFMA warp-instruction per clock on each of an SM's four
// schedulers, so every other instruction (a shared-memory load, an exp2, a
// shuffle, a barrier wait) takes an issue slot from an FFMA. The design is
// about the share of FFMAs among the instructions issued:
//
// 1. Register tiles. A block of 256 threads takes BQ query rows and walks
//    the keys in tiles of BK. TR neighbouring lanes share TM query rows
//    (a row group); each lane owns a TM x TN tile of scores (keys t + TR i of
//    the tile, i < TN) and builds it as an SGEMM micro-kernel does: per four
//    dims, TM + TN 16-byte shared-memory loads (Q rows, K rows) feed
//    4 TM TN FFMAs. No shuffle is spent on a dot product. Q is loaded once
//    per block, pre-scaled by qscale = log2(e) / sqrt(D), into shared memory.
// 2. Asynchronous copies. K and V tiles come with cp.async (16 bytes, L2
//    only) into a ring of NSTAGE (K, V) stages in dynamic shared memory: the
//    copy of tile j + NSTAGE - 1 is issued right after the one barrier of
//    tile j and lands while tiles j .. j + NSTAGE - 2 are computed. Keys past
//    Lk are zero-filled by the copy (source size 0), never read from the next
//    head. Rows of Q, K and V are D + 4 floats apart (an odd number of
//    16-byte units), so the neighbouring rows that one load instruction reads
//    fall on distinct banks; every D takes 16-byte rows.
// 3. The online softmax once per tile. Scores of keys past Lk are set to
//    -inf (last tile only). Each lane takes the max over its TN scores; the
//    row's TR lanes combine them with log2(TR) shuffles once per tile; exp2
//    runs once per (row, key) (ex2.approx.ftz) and once per row for the
//    correction exp2(m_old - m_new). Each lane keeps the sum of its own keys;
//    the TR partial sums are combined once, at the end.
// 4. P V with the rescale in registers. P goes through shared memory, each
//    warp to its own rows (only __syncwarp orders it). A lane accumulates a
//    TM x TD tile of O (TD = D / TR columns, as 16-byte groups t + TR e): its
//    O rows are its score rows, so the correction never leaves registers.
//    Per four keys, TM loads of P and 4 TD / 4 loads of V rows feed 4 TM TD
//    FFMAs.
// 5. Instances. The split (TR, TN, TM, NSTAGE, PARTS) is fixed per head dim
//    (Split below): the TM x TD accumulators and TM x TN scores fill the 255
//    registers of a thread without spilling, and Q, the ring and P fit the
//    227 KB of shared memory a block may use (one block per SM). The splits
//    were picked on the card (tools/k3_f32_tiles.py): halving TM or TN was
//    slower. D = 512 takes TR = 16 lanes per row, two rows each, and 16-key
//    tiles in two stages, as its 2 KB rows leave room for no more; there one
//    K load feeds only 8 FFMAs. Each head dim also has a narrow
//    instance with TM = 1 (a quarter of the rows per block, half at 512): the
//    launch takes it when the wide instance would give fewer blocks than half
//    the card's 132 SMs (the tiny loop's L <= 64, the 8x8 level's 64 rows), a
//    fixed rule on (B*H, Lq, D).
//
// Rows past Lq are computed on zeros and not stored.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kSMs = 132;              // the H100 SXM's streaming multiprocessors
constexpr int kMaxDevices = 64;

template <int D_, int TR_, int TM_, int TN_, int NSTAGE_, int PARTS_>
struct Tile {
  static constexpr int D = D_;
  static constexpr int TR = TR_;          // lanes of a row group
  static constexpr int TM = TM_;          // query rows per lane
  static constexpr int TN = TN_;          // keys per lane in a tile
  static constexpr int NSTAGE = NSTAGE_;  // (K, V) tiles in the ring
  static constexpr int PARTS = PARTS_;    // partial sums of a score (1, or 4: one per dim mod 4)
  static constexpr int CB = PARTS == 1 ? D / 4 : 8;  // chunks of 4 dims summed before joining s
  static constexpr int BK = TR * TN;      // keys per tile
  static constexpr int TD = D / TR;       // output columns per lane
  static constexpr int RSTEP = 32 / TR;   // row groups per warp: a lane's rows are RSTEP apart
  static constexpr int BQ = kThreads / TR * TM;  // query rows per block
  static constexpr int LD = D + 4;        // row stride of Q, K and V in shared memory (floats)
  static constexpr int PLD = BK + 4;      // row stride of P
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int KV_FLOATS = BK * LD;
  static constexpr int SMEM = (Q_FLOATS + NSTAGE * 2 * KV_FLOATS + BQ * PLD) * (int)sizeof(float);
  static_assert(TD % 4 == 0, "a lane's output columns are whole 16-byte groups");
  static_assert(32 % TR == 0 && (TR & (TR - 1)) == 0, "a row group is a power of two within a warp");
  static_assert((LD / 4) % 2 == 1, "rows are an odd number of 16-byte units apart");
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
  static_assert(PARTS == 1 || PARTS == 4, "one partial sum, or one per dim mod 4");
  static_assert((D / 4) % CB == 0, "whole blocks of chunks");
};

// (TR, TN, TM of the wide instance, NSTAGE, PARTS) per head dim. At
// D = 512 a score sums 512 products, and with sharp logits (x30) one running
// fp32 sum puts the output ~1.7e-4 from the exact one: there four partial
// sums (dims 4c + a, a < 4) over blocks of 32 dims, each block added into the
// score, cut that to ~3e-5 (a lane holds only two scores, so the registers
// are there).
template <int D> struct Split;
template <> struct Split<16>  { static constexpr int TR = 2,  TN = 16, TM = 4, NSTAGE = 3, PARTS = 1; };
template <> struct Split<32>  { static constexpr int TR = 2,  TN = 16, TM = 4, NSTAGE = 3, PARTS = 1; };
template <> struct Split<40>  { static constexpr int TR = 2,  TN = 16, TM = 4, NSTAGE = 3, PARTS = 1; };
template <> struct Split<64>  { static constexpr int TR = 4,  TN = 8,  TM = 4, NSTAGE = 3, PARTS = 1; };
template <> struct Split<80>  { static constexpr int TR = 4,  TN = 8,  TM = 4, NSTAGE = 3, PARTS = 1; };
template <> struct Split<160> { static constexpr int TR = 8,  TN = 4,  TM = 4, NSTAGE = 3, PARTS = 1; };
template <> struct Split<512> { static constexpr int TR = 16, TN = 1,  TM = 2, NSTAGE = 2, PARTS = 4; };

template <int D, bool kNarrow>
using TileOf = Tile<D, Split<D>::TR, kNarrow ? 1 : Split<D>::TM, Split<D>::TN, Split<D>::NSTAGE,
                    Split<D>::PARTS>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only; `bytes` = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Issue the copies of K and V tile j into its stage of the ring (none past
// the last tile), then commit them as one group.
template <class T>
__device__ __forceinline__ void issue_tile(float* ring, const float* kb, const float* vb, int j, int ntiles,
                                           int Lk) {
  constexpr int C4 = T::D / 4, N = 2 * T::BK * C4;
  if (j < ntiles) {
    float* dst = ring + (j % T::NSTAGE) * 2 * T::KV_FLOATS;
    const int key0 = j * T::BK;
#pragma unroll
    for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (N % kThreads == 0 || i < N) {
        const int which = i / (T::BK * C4), rem = i % (T::BK * C4);
        const int key = rem / C4, c = rem % C4;
        const bool in = key0 + key < Lk;
        const float* src = (which ? vb : kb) + (size_t)(in ? key0 + key : 0) * T::D + 4 * c;
        cp_async16(smem_u32(dst + which * T::KV_FLOATS + key * T::LD + 4 * c), src, in ? 16 : 0);
      }
    }
  }
  cp_async_commit();
}

template <class T>
__global__ void __launch_bounds__(kThreads, T::TM == 1 ? 2 : 1) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int Lq, int Lk, float qscale) {
  constexpr int D = T::D, TR = T::TR, TM = T::TM, TN = T::TN, BK = T::BK, TD = T::TD;
  constexpr int LD = T::LD, PLD = T::PLD, RSTEP = T::RSTEP, C4 = D / 4, PARTS = T::PARTS, CB = T::CB;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // [BQ][LD], pre-scaled
  float* ring = qs + T::Q_FLOATS;                     // NSTAGE x ([BK][LD] K, [BK][LD] V)
  float* ps = ring + T::NSTAGE * 2 * T::KV_FLOATS;    // [BQ][PLD]

  const size_t bh = blockIdx.y;
  const float* kb = k + bh * Lk * D;
  const float* vb = v + bh * Lk * D;
  const int q0 = blockIdx.x * T::BQ;
  const int ntiles = (Lk + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < T::NSTAGE - 1; ++s) issue_tile<T>(ring, kb, vb, s, ntiles, Lk);

  {  // Q: device memory -> registers, scaled -> shared memory
    const float* qb = q + (bh * Lq + q0) * D;
    constexpr int N = T::BQ * C4;
#pragma unroll 4
    for (int i = threadIdx.x; i < N; i += kThreads) {
      const int row = i / C4, c = i % C4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + row < Lq) x = *reinterpret_cast<const float4*>(qb + (size_t)row * D + 4 * c);
      *reinterpret_cast<float4*>(qs + row * LD + 4 * c) =
          make_float4(x.x * qscale, x.y * qscale, x.z * qscale, x.w * qscale);
    }
  }

  const int lane = threadIdx.x % 32, t = lane % TR;
  const int r0 = threadIdx.x / 32 * (RSTEP * TM) + lane / TR;  // this lane's first row in the block
  const float* qrow = qs + r0 * LD;
  float* prow = ps + r0 * PLD;

  float acc[TM][TD], m[TM], l[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < TD; ++e) acc[r][e] = 0.f;
  }

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<T::NSTAGE - 2>();  // this thread's copies of tile j have landed
    __syncthreads();                 // everyone's have, and tile j - 1's stage is free
    issue_tile<T>(ring, kb, vb, j + T::NSTAGE - 1, ntiles, Lk);
    const float* ks = ring + (j % T::NSTAGE) * 2 * T::KV_FLOATS;
    const float* krow = ks + t * LD;
    const float* vcol = ks + T::KV_FLOATS + 4 * t;

    // S = (Q qscale) K^T for this lane's TM rows and TN keys, over blocks of
    // CB chunks of 4 dims, each block's PARTS partial sums added into s
    float s[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int i = 0; i < TN; ++i) s[r][i] = 0.f;
    }
#pragma unroll
    for (int c0 = 0; c0 < C4; c0 += CB) {
      float part[TM][TN][PARTS];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int i = 0; i < TN; ++i) {
#pragma unroll
          for (int a = 0; a < PARTS; ++a) part[r][i][a] = 0.f;
        }
      }
#pragma unroll
      for (int c = c0; c < c0 + CB; ++c) {
        float4 qf[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) qf[r] = lds4(qrow + r * RSTEP * LD + 4 * c);
#pragma unroll
        for (int i = 0; i < TN; ++i) {
          const float4 kf = lds4(krow + i * TR * LD + 4 * c);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            float* a = part[r][i];
            a[0] = fmaf(qf[r].x, kf.x, a[0]);
            a[1 % PARTS] = fmaf(qf[r].y, kf.y, a[1 % PARTS]);
            a[2 % PARTS] = fmaf(qf[r].z, kf.z, a[2 % PARTS]);
            a[3 % PARTS] = fmaf(qf[r].w, kf.w, a[3 % PARTS]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int i = 0; i < TN; ++i) {
          const float* a = part[r][i];
          if (PARTS == 1) {
            s[r][i] = CB == C4 ? a[0] : s[r][i] + a[0];
          } else {
            s[r][i] += (a[0] + a[1 % PARTS]) + (a[2 % PARTS] + a[3 % PARTS]);
          }
        }
      }
    }
    const int valid = Lk - j * BK;  // keys of this tile inside Lk
    if (valid < BK) {
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        if (t + i * TR >= valid) {
#pragma unroll
          for (int r = 0; r < TM; ++r) s[r][i] = -CUDART_INF_F;
        }
      }
    }

    // online softmax: the row max once per tile, exp2 once per (row, key)
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int i = 1; i < TN; ++i) mx = fmaxf(mx, s[r][i]);
#pragma unroll
      for (int off = TR / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);  // finite: key 0 of the first tile is never masked
      const float corr = ex2(m[r] - mn);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        s[r][i] = ex2(s[r][i] - mn);
        sum += s[r][i];
      }
      l[r] = fmaf(l[r], corr, sum);
#pragma unroll
      for (int e = 0; e < TD; ++e) acc[r][e] *= corr;
    }

    // P to this warp's rows of shared memory; the previous tile's reads of
    // them ended before the barrier above
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int i = 0; i < TN; ++i) prow[r * RSTEP * PLD + t + i * TR] = s[r][i];
    }
    __syncwarp();

    // O += P V: per four keys, TM loads of P and TD / 4 loads of each V row
#pragma unroll
    for (int kk = 0; kk < BK / 4; ++kk) {
      float4 pf[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) pf[r] = lds4(prow + r * RSTEP * PLD + 4 * kk);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* vr = vcol + (4 * kk + c) * LD;
#pragma unroll
        for (int e = 0; e < TD / 4; ++e) {
          const float4 vf = lds4(vr + 4 * TR * e);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float p = c == 0 ? pf[r].x : c == 1 ? pf[r].y : c == 2 ? pf[r].z : pf[r].w;
            acc[r][4 * e] = fmaf(p, vf.x, acc[r][4 * e]);
            acc[r][4 * e + 1] = fmaf(p, vf.y, acc[r][4 * e + 1]);
            acc[r][4 * e + 2] = fmaf(p, vf.z, acc[r][4 * e + 2]);
            acc[r][4 * e + 3] = fmaf(p, vf.w, acc[r][4 * e + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* ob = o + (bh * Lq + q0) * D;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    float sum = l[r];
#pragma unroll
    for (int off = TR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = r0 + r * RSTEP;
    if (q0 + row >= Lq) continue;
    const float inv = 1.f / sum;
#pragma unroll
    for (int e = 0; e < TD / 4; ++e) {
      *reinterpret_cast<float4*>(ob + (size_t)row * D + 4 * (t + TR * e)) =
          make_float4(acc[r][4 * e] * inv, acc[r][4 * e + 1] * inv, acc[r][4 * e + 2] * inv,
                      acc[r][4 * e + 3] * inv);
    }
  }
}

// The instance a shape takes: the narrow one where the wide one would give
// fewer blocks than half the SMs.
template <int D>
bool narrow(int BH, int Lq) {
  constexpr int BQ = TileOf<D, false>::BQ;
  return (long)BH * ((Lq + BQ - 1) / BQ) < kSMs / 2;
}

// Above 48 KB of dynamic shared memory a kernel must opt in: once per
// instance and device.
template <class T>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!(done.load() >> dev & 1ull)) {
    e = cudaFuncSetAttribute(flash_attention_f32_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return e;
    done.fetch_or(1ull << dev);
  }
  return cudaSuccess;
}

template <class T>
int launch_tile(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk, float qscale,
                cudaStream_t stream) {
  const cudaError_t e = opt_in<T>();
  if (e != cudaSuccess) return (int)e;
  const dim3 blocks((Lq + T::BQ - 1) / T::BQ, BH);
  flash_attention_f32_kernel<T><<<blocks, kThreads, T::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Lq, Lk, qscale);
  return (int)cudaGetLastError();
}

template <class T>
int tile_info(int* rows, int* blocks_per_sm) {
  *rows = T::BQ;
  *blocks_per_sm = 0;
  if (opt_in<T>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_attention_f32_kernel<T>, kThreads,
                                                    T::SMEM) != cudaSuccess)
    *blocks_per_sm = -1;
  return T::SMEM;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk, float qscale,
           cudaStream_t stream) {
  if (narrow<D>(BH, Lq)) return launch_tile<TileOf<D, true>>(q, k, v, o, BH, Lq, Lk, qscale, stream);
  return launch_tile<TileOf<D, false>>(q, k, v, o, BH, Lq, Lk, qscale, stream);
}

template <int D>
int tile_of(int BH, int Lq, int* rows, int* blocks_per_sm) {
  if (narrow<D>(BH, Lq)) return tile_info<TileOf<D, true>>(rows, blocks_per_sm);
  return tile_info<TileOf<D, false>>(rows, blocks_per_sm);
}

}  // namespace

extern "C" {

// q, o: (BH, Lq, D); k, v: (BH, Lk, D); float, contiguous, 16-byte aligned.
// qscale = log2(e) / sqrt(D). Launches on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape or
// D the kernel does not take.
int coma_flash_attention_f32(const void* q, const void* k, const void* v, void* o, int BH, int Lq,
                             int Lk, int D, float qscale, void* stream) {
  if (BH <= 0 || BH > 65535 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(q, k, v, o, BH, Lq, Lk, qscale, s);
    case 32: return launch<32>(q, k, v, o, BH, Lq, Lk, qscale, s);
    case 40: return launch<40>(q, k, v, o, BH, Lq, Lk, qscale, s);
    case 64: return launch<64>(q, k, v, o, BH, Lq, Lk, qscale, s);
    case 80: return launch<80>(q, k, v, o, BH, Lq, Lk, qscale, s);
    case 160: return launch<160>(q, k, v, o, BH, Lq, Lk, qscale, s);
    case 512: return launch<512>(q, k, v, o, BH, Lq, Lk, qscale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The instance a (BH, Lq, D) call launches: its dynamic shared memory per
// block in bytes (the return value; 0 for a D without an instance), its query
// rows per block (*rows) and the blocks of it an SM holds at once
// (*blocks_per_sm, from the occupancy calculator; -1 if that failed).
int coma_flash_attention_f32_tile(int BH, int Lq, int D, int* rows, int* blocks_per_sm) {
  *rows = *blocks_per_sm = 0;
  switch (D) {
    case 16: return tile_of<16>(BH, Lq, rows, blocks_per_sm);
    case 32: return tile_of<32>(BH, Lq, rows, blocks_per_sm);
    case 40: return tile_of<40>(BH, Lq, rows, blocks_per_sm);
    case 64: return tile_of<64>(BH, Lq, rows, blocks_per_sm);
    case 80: return tile_of<80>(BH, Lq, rows, blocks_per_sm);
    case 160: return tile_of<160>(BH, Lq, rows, blocks_per_sm);
    case 512: return tile_of<512>(BH, Lq, rows, blocks_per_sm);
    default: return 0;
  }
}

const char* coma_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
