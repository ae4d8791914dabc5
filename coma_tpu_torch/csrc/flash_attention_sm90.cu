// K3 in bf16: scaled dot-product attention, softmax(Q K^T / sqrt(D)) V,
// non-causal, on Hopper's tensor cores (sm_90a: wgmma, TMA, mbarrier,
// setmaxnreg).
//
// Replaces, for bf16, the TPU route of coma_tpu/ops/attention.py:41
// scaled_dot_attention, which calls the JAX library's Pallas flash_attention
// (:44-59) when Lq == Lk >= 1024, L % 512 == 0 and D % 128 == 0, and XLA's
// einsum chain (_xla_attention, :17) otherwise. Its plain version is
// coma_tpu_torch/ops/attention.py attention_reference; the wrapper is
// coma_tpu_torch/ops/attention.py scaled_dot_attention, which sends every
// bf16 call here and every float32 call to flash_attention.cu. On the card
// every call of the inpainting path is bf16: the UNet's self- and
// cross-attention (D = 40/80/160, Lk = Lq or 77) and the VAE's mid block
// (D = 512, one head).
//
// What bounds it on the H100. 4 Lq Lk D operations per (batch, head) slice
// against 2 (Lq + Lk) D bf16 bytes: at the UNet's 64x64 self-attention
// (8 x 8 slices, Lq = Lk = 4096, D = 40) 0.17 ms at the 989 TFLOP/s bf16
// tensor-core peak against 0.01 ms of memory traffic, so operations bound it.
// Two more limits sit beside the tensor cores. (1) The exponentials:
// 8 * 8 * 4096^2 = 1.07e9 exp2 on the MUFU units (16 a clock per SM,
// ~4e12/s) take ~0.27 ms, more than the tensor-core bound at D = 40, and the
// softmax's max, scale, sum and bf16 conversions add ~6 FP32-pipe
// instructions per score. (2) Rounding: P must be rounded to bf16 to enter
// the tensor cores, and one rounding (2^-8 relative) of each weight is too
// coarse for the limit the port holds K3 to, |kernel - plain(fp32)| <=
// 5e-4 + 8e-3 |plain| (at Lk = 77 it needs more than twice that atol over
// ~1e6 outputs; tests/test_torch_attention.py emulates it). So P is split into
// two bf16 terms, P = P_hi + P_lo with P_lo = bf16(P - P_hi), and P V runs
// as two products into one fp32 accumulator: the error is then ~2^-16
// relative, at the cost of doubling the P V half of the tensor-core work.
//
// Design (FlashAttention-3's shape). A block has three warpgroups. The first
// is the producer: it drops to 40 registers, and one thread issues TMA loads
// of the Q tile once and of K and V tiles into rings of two stages in
// dynamic shared memory, each stage with a "full" mbarrier (the TMA reports
// its bytes there) and an "empty" one (the consumers release it); K and V
// have rings of their own, so a K tile is released as soon as its scores
// are formed. The other two are consumers and rise to 232 registers. Each
// consumer warpgroup forms S = Q K^T for 64 query rows with wgmma (both from
// shared memory, K-major, 128-byte swizzle), and keeps S in fp32 registers.
// The softmax is online in fp32: keys >= Lk masked to -inf, the running max
// and sum per row, exponentials as exp2 of S * log2(e)/sqrt(D) minus the
// scaled max (the scale is applied to S in fp32, so Q is not rounded
// again). P (hi and lo) is packed to bf16 in registers: the accumulator
// layout of the first wgmma is the register-A fragment of the second, so
// O += P V is a wgmma with A from registers and V from shared memory
// (MN-major, transposed by the instruction). The loop overlaps them: the
// next tile's Q K^T and this tile's P V are issued together, the softmax of
// the next tile runs while P V is in flight, and the two consumer
// warpgroups interleave on the SM's schedulers.
//
// Shapes. Tiles are 3-D tensor maps (D, L, B*H), so a box past Lq or Lk
// reads zeros and never the next head's rows, and rows >= Lq are not
// stored. Rows of shared memory are 64 columns (128 bytes, one swizzle
// atom): D = 40 is one chunk with its columns 40..63 zero-filled by the
// TMA (declared width D, box width 64), and Q K^T runs over K = 48 (three
// k-steps of 16); D = 80 and 160 take two and three chunks. P V's N is D
// itself (a multiple of 8). D = 512 (the VAE) does not fit one warpgroup's
// registers as a 64 x 512 fp32 accumulator, so there the two consumer
// warpgroups share one 64-row Q tile, both form the same S and each
// accumulates 256 of the output columns; K and V tiles of 32 keys keep Q
// (64 KB) and two K/V stages (128 KB) inside the 227 KB a block may use.
//
// Host side. The tensor maps are encoded here with cuTensorMapEncodeTiled,
// found through cudaGetDriverEntryPoint, so the library links no -lcuda;
// they travel as __grid_constant__ kernel parameters. TMA needs 16-byte
// aligned base addresses and row strides (D * 2 bytes); the wrapper checks
// the bases.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kConsumers = 2;                      // consumer warpgroups per block
constexpr int kThreads = 128 * (kConsumers + 1);   // and the producer warpgroup
constexpr int kChunkBytes = 128;                   // a shared-memory row: 64 bf16
constexpr int kStages = 2;                         // tiles in each of the K and V rings
constexpr int kEncodeError = 100000;               // + CUresult of a failed encode
constexpr int kNoEncoder = 99999;                  // cuTensorMapEncodeTiled not found

// ---------------------------------------------------------------------------
// PTX: shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed. A wait that
// outlasts ~10 s of clocks traps (the launch then fails with an error)
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000ll) {
      __trap();
    }
  }
}

// One box of a 3-D tensor map, at element coordinates (c0, c1, c2), into
// shared memory; its bytes are reported to `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep a register's value where an asynchronous wgmma reads or writes it:
// the compiler may not move its uses across this point.
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// A wgmma shared-memory descriptor for a tile written by TMA with the
// 128-byte swizzle: start address, leading and stride byte offsets (in
// 16-byte units), layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// "%0, ..., %(n-1)": the accumulator operands of a wgmma with n = N/2
// registers per thread, and the matching "+f" constraints on d[0..n-1].
#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_R4 "%0, %1, %2, %3"
#define WG_R8 WG_R4 ", %4, %5, %6, %7"
#define WG_R12 WG_R8 ", %8, %9, %10, %11"
#define WG_R16 WG_R12 ", %12, %13, %14, %15"
#define WG_R20 WG_R16 ", %16, %17, %18, %19"
#define WG_R24 WG_R20 ", %20, %21, %22, %23"
#define WG_R28 WG_R24 ", %24, %25, %26, %27"
#define WG_R32 WG_R28 ", %28, %29, %30, %31"
#define WG_R36 WG_R32 ", %32, %33, %34, %35"
#define WG_R40 WG_R36 ", %36, %37, %38, %39"
#define WG_R44 WG_R40 ", %40, %41, %42, %43"
#define WG_R48 WG_R44 ", %44, %45, %46, %47"
#define WG_R52 WG_R48 ", %48, %49, %50, %51"
#define WG_R56 WG_R52 ", %52, %53, %54, %55"
#define WG_R60 WG_R56 ", %56, %57, %58, %59"
#define WG_R64 WG_R60 ", %60, %61, %62, %63"
#define WG_R68 WG_R64 ", %64, %65, %66, %67"
#define WG_R72 WG_R68 ", %68, %69, %70, %71"
#define WG_R76 WG_R72 ", %72, %73, %74, %75"
#define WG_R80 WG_R76 ", %76, %77, %78, %79"
#define WG_R84 WG_R80 ", %80, %81, %82, %83"
#define WG_R88 WG_R84 ", %84, %85, %86, %87"
#define WG_R92 WG_R88 ", %88, %89, %90, %91"
#define WG_R96 WG_R92 ", %92, %93, %94, %95"
#define WG_R100 WG_R96 ", %96, %97, %98, %99"
#define WG_R104 WG_R100 ", %100, %101, %102, %103"
#define WG_R108 WG_R104 ", %104, %105, %106, %107"
#define WG_R112 WG_R108 ", %108, %109, %110, %111"
#define WG_R116 WG_R112 ", %112, %113, %114, %115"
#define WG_R120 WG_R116 ", %116, %117, %118, %119"
#define WG_R124 WG_R120 ", %120, %121, %122, %123"
#define WG_R128 WG_R124 ", %124, %125, %126, %127"
#define WG_O4 WG_D4(0)
#define WG_O8 WG_O4, WG_D4(4)
#define WG_O12 WG_O8, WG_D4(8)
#define WG_O16 WG_O12, WG_D4(12)
#define WG_O20 WG_O16, WG_D4(16)
#define WG_O24 WG_O20, WG_D4(20)
#define WG_O28 WG_O24, WG_D4(24)
#define WG_O32 WG_O28, WG_D4(28)
#define WG_O36 WG_O32, WG_D4(32)
#define WG_O40 WG_O36, WG_D4(36)
#define WG_O44 WG_O40, WG_D4(40)
#define WG_O48 WG_O44, WG_D4(44)
#define WG_O52 WG_O48, WG_D4(48)
#define WG_O56 WG_O52, WG_D4(52)
#define WG_O60 WG_O56, WG_D4(56)
#define WG_O64 WG_O60, WG_D4(60)
#define WG_O68 WG_O64, WG_D4(64)
#define WG_O72 WG_O68, WG_D4(68)
#define WG_O76 WG_O72, WG_D4(72)
#define WG_O80 WG_O76, WG_D4(76)
#define WG_O84 WG_O80, WG_D4(80)
#define WG_O88 WG_O84, WG_D4(84)
#define WG_O92 WG_O88, WG_D4(88)
#define WG_O96 WG_O92, WG_D4(92)
#define WG_O100 WG_O96, WG_D4(96)
#define WG_O104 WG_O100, WG_D4(100)
#define WG_O108 WG_O104, WG_D4(104)
#define WG_O112 WG_O108, WG_D4(108)
#define WG_O116 WG_O112, WG_D4(112)
#define WG_O120 WG_O116, WG_D4(116)
#define WG_O124 WG_O120, WG_D4(120)
#define WG_O128 WG_O124, WG_D4(124)

// d (64 x N, fp32, N/2 registers a thread) = A B (+ d if `accumulate`), A
// (64 x 16) and B (16 x N) bf16 in shared memory, both K-major.
template <int N> __device__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int accumulate);
// d += A B, A (64 x 16) bf16 in registers (4 a thread), B (16 x N) bf16 in
// shared memory, MN-major (transposed by the instruction).
template <int N> __device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

#define WGMMA_SS(N, NR, IA, IB, IS)                                                             \
  template <> __device__ __forceinline__ void wgmma_ss<N>(float* d, uint64_t a, uint64_t b,     \
                                                          int accumulate) {                     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" WG_R##NR "}, %" #IA \
                 ", %" #IB ", p, 1, 1, 0, 0;\n}\n"                                               \
                 : WG_O##NR                                                                     \
                 : "l"(a), "l"(b), "r"(accumulate));                                            \
  }
#define WGMMA_RS(N, NR, A0, A1, A2, A3, IB, IS)                                                 \
  template <> __device__ __forceinline__ void wgmma_rs<N>(float* d, const uint32_t* a,          \
                                                          uint64_t b) {                         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" WG_R##NR "}, {%" #A0 \
                 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #IB ", p, 1, 1, 1;\n}\n"                    \
                 : WG_O##NR                                                                     \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                 \
  }

WGMMA_SS(32, 16, 16, 17, 18)
WGMMA_SS(64, 32, 32, 33, 34)
WGMMA_SS(128, 64, 64, 65, 66)
WGMMA_RS(16, 8, 8, 9, 10, 11, 12, 13)
WGMMA_RS(32, 16, 16, 17, 18, 19, 20, 21)
WGMMA_RS(40, 20, 20, 21, 22, 23, 24, 25)
WGMMA_RS(64, 32, 32, 33, 34, 35, 36, 37)
WGMMA_RS(80, 40, 40, 41, 42, 43, 44, 45)
WGMMA_RS(160, 80, 80, 81, 82, 83, 84, 85)
WGMMA_RS(256, 128, 128, 129, 130, 131, 132, 133)

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

// ---------------------------------------------------------------------------
// Tiles per head dim
// ---------------------------------------------------------------------------

// BK keys per K/V tile; SPLIT: the consumer warpgroups share 64 query rows
// and split the output columns.
template <int D> struct Tile { static constexpr int BK = 128; static constexpr bool SPLIT = false; };
template <> struct Tile<160> { static constexpr int BK = 64; static constexpr bool SPLIT = false; };
template <> struct Tile<512> { static constexpr int BK = 32; static constexpr bool SPLIT = true; };

template <int D> struct Shape {
  static constexpr int BK = Tile<D>::BK;
  static constexpr bool SPLIT = Tile<D>::SPLIT;
  static constexpr int CH = (D + 63) / 64;                   // 128-byte chunks of a row
  static constexpr int KSTEPS = (D + 15) / 16;               // k-steps of Q K^T
  static constexpr int QTILES = SPLIT ? 1 : kConsumers;      // 64-row Q tiles per block
  static constexpr int ROWS = 64 * QTILES;                   // query rows per block
  static constexpr int NO = SPLIT ? D / kConsumers : D;      // output columns per consumer
  static constexpr int QCHUNK = 64 * kChunkBytes;            // one chunk of a Q tile
  static constexpr int KVCHUNK = BK * kChunkBytes;           // one chunk of a K or V tile
  static constexpr int QBYTES = QTILES * CH * QCHUNK;
  static constexpr int KVBYTES = CH * KVCHUNK;
  static constexpr int BARRIERS = 1 + 4 * kStages;
  static constexpr int SMEM = 1024 + QBYTES + 2 * kStages * KVBYTES + 8 * BARRIERS;
  static_assert(D % 8 == 0 && NO % 8 == 0, "wgmma's N is a multiple of 8");
  static_assert(BK % 16 == 0 && NO <= 256, "wgmma shapes");
  static_assert(SMEM <= 232448, "a block has at most 227 KB of shared memory");
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int Lq, int Lk,
    float scale_log2) {
  using S = Shape<D>;
  constexpr int BK = S::BK, NO = S::NO, NP = BK / 4;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + S::QBYTES;
  uint8_t* vs = ks + kStages * S::KVBYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * S::KVBYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * S::ROWS;
  const int ntiles = (Lk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kConsumers);
      mbar_init(v_empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, S::QBYTES);
      for (int t = 0; t < S::QTILES; ++t)
        for (int c = 0; c < S::CH; ++c)
          tma_load_3d(qs + (t * S::CH + c) * S::QCHUNK, &tq, q_full, 64 * c, row0 + 64 * t, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        const uint32_t free_parity = ((j / kStages) & 1) ^ 1;   // the first round finds it free
        mbar_wait(k_empty + s, free_parity);
        mbar_expect_tx(k_full + s, S::KVBYTES);
        for (int c = 0; c < S::CH; ++c)
          tma_load_3d(ks + s * S::KVBYTES + c * S::KVCHUNK, &tk, k_full + s, 64 * c, j * BK, bh);
        mbar_wait(v_empty + s, free_parity);
        mbar_expect_tx(v_full + s, S::KVBYTES);
        for (int c = 0; c < S::CH; ++c)
          tma_load_3d(vs + s * S::KVBYTES + c * S::KVCHUNK, &tv, v_full + s, 64 * c, j * BK, bh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int w = wg - 1;                       // consumer warpgroup
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r = 16 * (t / 32) + lane / 4;     // this thread's rows r and r + 8 of the 64-row tile
  const int qrow = row0 + (S::SPLIT ? 0 : 64 * w);
  const int col0 = S::SPLIT ? w * NO : 0;     // this warpgroup's output columns
  const uint32_t q_addr = smem_u32(qs + (S::SPLIT ? 0 : w * S::CH * S::QCHUNK));

  float acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, corr[2];
  float s[BK / 2];
  uint32_t pa_hi[NP], pa_lo[NP], pb_hi[NP], pb_lo[NP];

  // S = Q K^T for the K tile in `stage`
  auto issue_qk = [&](int stage) {
    const uint32_t k_addr = smem_u32(ks + stage * S::KVBYTES);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) keep(s[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::KSTEPS; ++kk) {
      const uint32_t kofs = (kk % 4) * 32;
      const uint64_t da = desc_sw128(q_addr + (kk / 4) * S::QCHUNK + kofs, 16, 1024);
      const uint64_t db = desc_sw128(k_addr + (kk / 4) * S::KVCHUNK + kofs, 16, 1024);
      wgmma_ss<BK>(s, da, db, kk > 0);
    }
    wgmma_commit();
  };

  // acc += (P_hi + P_lo) V for the V tile in `stage`
  auto issue_pv = [&](uint32_t(&p_hi)[NP], uint32_t(&p_lo)[NP], int stage) {
    const uint32_t v_addr = smem_u32(vs + stage * S::KVBYTES) + (col0 / 64) * S::KVCHUNK;
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) keep(acc[i]);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      keep(p_hi[i]);
      keep(p_lo[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = desc_sw128(v_addr + kk * 16 * kChunkBytes, S::KVCHUNK, 1024);
      wgmma_rs<NO>(acc, p_hi + 4 * kk, db);
      wgmma_rs<NO>(acc, p_lo + 4 * kk, db);
    }
    wgmma_commit();
  };

  // The scores of tile j, in s, become P (hi, lo) against the new running
  // max; corr rescales what was accumulated against the old one.
  auto softmax = [&](int j, uint32_t(&p_hi)[NP], uint32_t(&p_lo)[NP]) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) keep(s[i]);
    if ((j + 1) * BK > Lk) {
      const int key0 = j * BK + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (key0 + 8 * (i / 4) + (i % 2) >= Lk) s[i] = -CUDART_INF_F;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2_approx((m[h] - mx[h]) * scale_log2);
      m[h] = mx[h];
      ms[h] = mx[h] * scale_log2;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int h = (i / 2) % 2;
      const float p0 = exp2_approx(fmaf(s[i], scale_log2, -ms[h]));
      const float p1 = exp2_approx(fmaf(s[i + 1], scale_log2, -ms[h]));
      sum[h] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 back = __bfloat1622float2(hi);
      p_hi[i / 2] = bits(hi);
      p_lo[i / 2] = bits(__floats2bfloat162_rn(p0 - back.x, p1 - back.y));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
  };

  auto release = [&](uint64_t* bar) {
    if (t == 0) mbar_arrive(bar);
  };

  // One step of the loop, j >= 1: S of tile j and P V of tile j - 1 in
  // flight together; the softmax of tile j runs while P V finishes.
  auto step = [&](int j, uint32_t(&pin_hi)[NP], uint32_t(&pin_lo)[NP], uint32_t(&pout_hi)[NP],
                  uint32_t(&pout_lo)[NP]) {
    const int sk = j % kStages, sv = (j - 1) % kStages;
    mbar_wait(k_full + sk, (j / kStages) & 1);
    issue_qk(sk);
    mbar_wait(v_full + sv, ((j - 1) / kStages) & 1);
    issue_pv(pin_hi, pin_lo, sv);
    wgmma_wait<1>();
    release(k_empty + sk);
    softmax(j, pout_hi, pout_lo);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      keep(pin_hi[i]);
      keep(pin_lo[i]);
    }
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) keep(acc[i]);
    release(v_empty + sv);
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) acc[i] *= corr[(i / 2) % 2];
  };

  // The last P V, then o = acc / l for rows < Lq.
  auto finish = [&](uint32_t(&p_hi)[NP], uint32_t(&p_lo)[NP]) {
    const int sv = (ntiles - 1) % kStages;
    mbar_wait(v_full + sv, ((ntiles - 1) / kStages) & 1);
    issue_pv(p_hi, p_lo, sv);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) keep(acc[i]);
    release(v_empty + sv);
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.f / l[h];
    }
    __nv_bfloat16* ob = o + static_cast<size_t>(bh) * Lq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qrow + r + 8 * h;
      if (row >= Lq) continue;
      __nv_bfloat16* orow = ob + static_cast<size_t>(row) * D + col0 + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < NO / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * h] * inv[h], acc[4 * n + 2 * h + 1] * inv[h]);
    }
  };

  // tile 0
  mbar_wait(q_full, 0);
  mbar_wait(k_full, 0);
  issue_qk(0);
  wgmma_wait<0>();
  release(k_empty);
  softmax(0, pa_hi, pa_lo);

  int j = 1;
  for (; j + 1 < ntiles; j += 2) {
    step(j, pa_hi, pa_lo, pb_hi, pb_lo);
    step(j + 1, pb_hi, pb_lo, pa_hi, pa_lo);
  }
  if (j < ntiles) {
    step(j, pa_hi, pa_lo, pb_hi, pb_lo);
    finish(pb_hi, pb_lo);
  } else {
    finish(pa_hi, pa_lo);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B*H, L, D) bf16, contiguous, as a 3-D map (D, L, B*H) with boxes of
// (64, rows, 1): columns past D and rows past L read as zeros.
int encode(CUtensorMap* map, const void* base, int D, int L, int BH, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)D * 2 * L};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk, float scale_log2,
           cudaStream_t stream) {
  using S = Shape<D>;
  CUtensorMap tq, tk, tv;
  int e = encode(&tq, q, D, Lq, BH, 64);
  if (e == 0) e = encode(&tk, k, D, Lk, BH, S::BK);
  if (e == 0) e = encode(&tv, v, D, Lk, BH, S::BK);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(flash_attention_sm90_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (a != cudaSuccess) return (int)a;
  const dim3 blocks((Lq + S::ROWS - 1) / S::ROWS, BH);
  flash_attention_sm90_kernel<D><<<blocks, kThreads, S::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Lq, Lk, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (BH, Lq, D); k, v: (BH, Lk, D); bf16, contiguous, 16-byte aligned.
// scale_log2 = log2(e) / sqrt(D). Launches on `stream`; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a shape or D
// the kernel does not take, or a code above 99998 when a tensor map cannot
// be made (coma_cuda_error_string says which).
int coma_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk,
                              int D, float scale_log2, void* stream) {
  if (BH <= 0 || BH > 65535 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(q, k, v, o, BH, Lq, Lk, scale_log2, s);
    case 32: return launch<32>(q, k, v, o, BH, Lq, Lk, scale_log2, s);
    case 40: return launch<40>(q, k, v, o, BH, Lq, Lk, scale_log2, s);
    case 64: return launch<64>(q, k, v, o, BH, Lq, Lk, scale_log2, s);
    case 80: return launch<80>(q, k, v, o, BH, Lq, Lk, scale_log2, s);
    case 160: return launch<160>(q, k, v, o, BH, Lq, Lk, scale_log2, s);
    case 512: return launch<512>(q, k, v, o, BH, Lq, Lk, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of the instance for head dim D takes, in
// bytes (0 for a D without an instance).
int coma_flash_attention_bf16_smem(int D) {
  switch (D) {
    case 16: return Shape<16>::SMEM;
    case 32: return Shape<32>::SMEM;
    case 40: return Shape<40>::SMEM;
    case 64: return Shape<64>::SMEM;
    case 80: return Shape<80>::SMEM;
    case 160: return Shape<160>::SMEM;
    case 512: return Shape<512>::SMEM;
    default: return 0;
  }
}

const char* coma_cuda_error_string(int code) {
  static char msg[96];
  if (code == kNoEncoder) return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (code >= kEncodeError) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d", code - kEncodeError);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
