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
// tensor-core kernel). The inpainting path at full width is bf16 throughout;
// float32 reaches this kernel from the tiny 64x64 loop and the tests.
//
// What it computes. For one (batch, head) slice, q (Lq, D), k and v (Lk, D),
// all contiguous float: o = softmax(q k^T / sqrt(D)) v. Every product, the
// running max and sum, and the output accumulator are fp32.
//
// What bounds it on the H100. 4 Lq Lk D operations per slice, float32 in and
// out: at (8, 8, 1024, 1024, 80) 0.32 ms at the 67 TFLOP/s FP32 rate, against
// 0.025 ms of memory traffic, so operations bound it. It runs them on the
// FP32 pipes, as a float32 product must to keep float32's precision (TF32
// tensor cores keep ~3 decimal digits).
//
// Design. One block of 256 threads per (batch*head, tile of BQ query rows).
// TPR threads share a query row; each owns DP = D / TPR of its dims, in
// pairs (dims 2(t + TPR e) and 2(t + TPR e) + 1), and R rows, so a thread
// keeps R x DP query values (pre-scaled by log2(e) / sqrt(D)) and R x DP
// output accumulators in registers. K and V tiles of BK keys are staged
// through shared memory as float (kept under the 48 KB default: fewer keys
// per tile at larger D). For each chunk of KC keys a thread forms partial
// dot products over its dims, the TPR threads of a row sum them with
// butterfly shuffles, and the row's running max and sum are updated online
// (exp2 of the pre-scaled scores); the accumulators are rescaled by
// exp2(m_old - m_new) and take p * v. Threads of a row read neighbouring
// 8-byte words of a key row, and all rows read the same key at once
// (broadcast), so the shared-memory reads are free of bank conflicts. Rows
// past Lq are computed on zeros and not stored; keys past Lk are zero-filled
// in shared memory and masked out of the softmax.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// TPR threads per query row, R rows per thread, BK keys per shared-memory
// tile (2 * BK * D * 4 bytes <= 48 KB), KC keys per register chunk.
template <int D> struct Config;
template <> struct Config<16>  { static constexpr int TPR = 4,  R = 4, BK = 128, KC = 8; };
template <> struct Config<32>  { static constexpr int TPR = 4,  R = 4, BK = 128, KC = 8; };
template <> struct Config<40>  { static constexpr int TPR = 4,  R = 4, BK = 128, KC = 8; };
template <> struct Config<64>  { static constexpr int TPR = 8,  R = 4, BK = 64,  KC = 8; };
template <> struct Config<80>  { static constexpr int TPR = 8,  R = 4, BK = 64,  KC = 8; };
template <> struct Config<160> { static constexpr int TPR = 16, R = 4, BK = 32,  KC = 8; };
template <> struct Config<512> { static constexpr int TPR = 32, R = 2, BK = 8,   KC = 8; };

template <int D> __host__ __device__ constexpr int block_rows() { return kThreads / Config<D>::TPR * Config<D>::R; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Lq, int Lk, float qscale) {
  constexpr int TPR = Config<D>::TPR, R = Config<D>::R, BK = Config<D>::BK, KC = Config<D>::KC;
  constexpr int NP = D / (2 * TPR);  // dim pairs per thread
  constexpr int BQ = block_rows<D>();
  static_assert(D % (2 * TPR) == 0, "D must split into pairs over TPR threads");
  static_assert(BK % KC == 0, "a tile holds whole chunks");
  static_assert(2 * BK * D * sizeof(float) <= 48 * 1024, "K/V tiles exceed 48 KB");
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];

  const size_t bh = blockIdx.y;
  const T* qb = q + bh * Lq * D;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;
  T* ob = o + bh * Lq * D;
  const int t = threadIdx.x % TPR;
  const int row0 = blockIdx.x * BQ + threadIdx.x / TPR * R;

  float qr[R][2 * NP], acc[R][2 * NP], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int e = 0; e < NP; ++e) {
      float2 x = make_float2(0.f, 0.f);
      if (row < Lq) x = load2(qb + (size_t)row * D + 2 * (t + TPR * e));
      qr[r][2 * e] = x.x * qscale;
      qr[r][2 * e + 1] = x.y * qscale;
      acc[r][2 * e] = 0.f;
      acc[r][2 * e + 1] = 0.f;
    }
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    const int nk = min(BK, Lk - k0);
    __syncthreads();  // the previous tile is consumed
    const T* kt = kb + (size_t)k0 * D;
    const T* vt = vb + (size_t)k0 * D;
    for (int i = 2 * threadIdx.x; i < BK * D; i += 2 * kThreads) {
      float2 kx = make_float2(0.f, 0.f), vx = make_float2(0.f, 0.f);
      if (i < nk * D) {
        kx = load2(kt + i);
        vx = load2(vt + i);
      }
      store2(ks + i, kx.x, kx.y);
      store2(vs + i, vx.x, vx.y);
    }
    __syncthreads();

    for (int c0 = 0; c0 < nk; c0 += KC) {
      float s[R][KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float* kr = ks + (c0 + j) * D + 2 * t;
        float2 kv[NP];
#pragma unroll
        for (int e = 0; e < NP; ++e) kv[e] = load2(kr + 2 * TPR * e);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < NP; ++e) {
            a = fmaf(qr[r][2 * e], kv[e].x, a);
            a = fmaf(qr[r][2 * e + 1], kv[e].y, a);
          }
          s[r][j] = a;
        }
      }
      // the TPR threads of a row are neighbouring lanes of one warp
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int j = 0; j < KC; ++j) s[r][j] += __shfl_xor_sync(0xffffffffu, s[r][j], off);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (c0 + j < nk) mx = fmaxf(mx, s[r][j]);
        }
        // mx is finite: key 0 of the first chunk is never masked
        const float corr = exp2f(m[r] - mx);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          s[r][j] = c0 + j < nk ? exp2f(s[r][j] - mx) : 0.f;
          sum += s[r][j];
        }
        l[r] = l[r] * corr + sum;
#pragma unroll
        for (int e = 0; e < 2 * NP; ++e) acc[r][e] *= corr;
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float* vr = vs + (c0 + j) * D + 2 * t;
        float2 vv[NP];
#pragma unroll
        for (int e = 0; e < NP; ++e) vv[e] = load2(vr + 2 * TPR * e);
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int e = 0; e < NP; ++e) {
            acc[r][2 * e] = fmaf(s[r][j], vv[e].x, acc[r][2 * e]);
            acc[r][2 * e + 1] = fmaf(s[r][j], vv[e].y, acc[r][2 * e + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= Lq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int e = 0; e < NP; ++e)
      store2(ob + (size_t)row * D + 2 * (t + TPR * e), acc[r][2 * e] * inv, acc[r][2 * e + 1] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk,
           float qscale, cudaStream_t stream) {
  const dim3 blocks((Lq + block_rows<D>() - 1) / block_rows<D>(), BH);
  flash_attention_kernel<T, D><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Lq, Lk, qscale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk, int D,
             float qscale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, BH, Lq, Lk, qscale, stream);
    case 32: return launch<T, 32>(q, k, v, o, BH, Lq, Lk, qscale, stream);
    case 40: return launch<T, 40>(q, k, v, o, BH, Lq, Lk, qscale, stream);
    case 64: return launch<T, 64>(q, k, v, o, BH, Lq, Lk, qscale, stream);
    case 80: return launch<T, 80>(q, k, v, o, BH, Lq, Lk, qscale, stream);
    case 160: return launch<T, 160>(q, k, v, o, BH, Lq, Lk, qscale, stream);
    case 512: return launch<T, 512>(q, k, v, o, BH, Lq, Lk, qscale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (BH, Lq, D); k, v: (BH, Lk, D); float, contiguous. qscale =
// log2(e) / sqrt(D). Launches on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape or D the kernel does not
// take.
int coma_flash_attention_f32(const void* q, const void* k, const void* v, void* o, int BH, int Lq,
                             int Lk, int D, float qscale, void* stream) {
  if (BH <= 0 || BH > 65535 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<float>(q, k, v, o, BH, Lq, Lk, D, qscale, (cudaStream_t)stream);
}

const char* coma_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
