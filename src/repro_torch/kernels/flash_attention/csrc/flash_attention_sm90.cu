// Causal GQA flash attention (prefill) for Hopper (sm_90a) on the tensor
// cores: bf16 Q, K, V tiles brought into shared memory by TMA, Q.K^T and
// P.V as wgmma, with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py, _flash_kernel) for bf16
// inputs at every head dim the port serves: 16, 32, 64, 80, 112 and 128
// (80 and 112 are HuBERT-XLarge's and Zamba2-7B's); float32 keeps the
// CUDA-core kernel in flash_attention.cu.  It computes
//   out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / G] * scale) v[b, t, h / G]
// over t <= s when causal (top-left alignment, rows >= cols), with the
// online softmax's running max and sum in float32 and the output rounded
// once to bf16.  G = H / Hkv query heads share one key/value head.
//
// Numerics: the products of bf16 inputs are exact in wgmma's float32
// accumulator, so S = Q.K^T is what the plain version computes up to the
// order of the sum.  One deviation from the TPU kernel, which keeps P in
// float32: P is rounded to bf16 before P.V (wgmma takes bf16 operands), a
// relative error of at most 2^-9 a term, under one ulp of the bf16 output.
// The row sums l are taken from the unrounded P.  Exponentials are
// ex2.approx (relative error about 2^-22) of scores scaled by
// scale * log2(e) in the same FMA that subtracts the row max.
//
// Layout: q and out [B, S, H, Dh], k and v [B, T, Hkv, Dh] (the model's own
// layout), each read through a 4-D TMA tensor map over (Dh, heads, rows,
// B) built on the host for every call from the tensor's own strides.  TMA
// needs each stride but the last to be a multiple of 16 bytes and each base
// pointer 16-byte aligned; the wrapper checks both and raises otherwise.
// out is contiguous.
//
// Padding: the kernel is templated on Dh and works at a padded width DP,
// Dh rounded up to 64 (16 and 32 -> 64; 80 and 112 -> 128).  The tensor
// maps keep the real Dh as their innermost extent and every box is 64
// columns, so TMA's out-of-bounds fill (FLOAT_OOB_FILL_NONE: zeros) supplies
// columns Dh .. DP - 1 of Q, K and V; each box's expect_tx counts the whole
// box, fill included.  Q.K^T takes Dh / 16 k-steps (zero columns would add
// nothing), P.V runs at n = DP with the extra accumulator columns (zero, as
// V's are) never stored, and the epilogue stores Dh columns a row.
//
// Bound: operations.  4*B*H*S*T*Dh/2 FLOPs when causal against about
// (2*B*S*H + 2*B*T*Hkv)*Dh*2 bytes: at the prefill shape (B=8, S=T=2048,
// H=9, Hkv=3, Dh=64) ~770 FLOPs a byte, above the H100's ~295, so the
// tensor cores are the limit.  A padded head dim does DP / Dh of the P.V
// work the bound counts (1.14x at Dh 112, 1.6x at Dh 80).
//
// Design: one CTA of two consumer warpgroups (256 threads) for 128 query
// rows of one (head, batch), 64 rows a warpgroup; query tiles numbered so
// that the longest rows (the most keys) start first.  Q is loaded once;
// K and V come in tiles of 128 keys through a two-stage ring in shared
// memory.  Every tile is a TMA box of 64 bf16 columns (128 bytes, one
// swizzle row) with 128-byte swizzle, so a padded width of 128 is two
// boxes; swizzled tiles are 1024-byte aligned.  Thread 0 issues tile j+1's
// loads before tile j's math, so one tile is always in flight; loads
// complete on mbarriers (K and V apart, so Q.K^T starts before V lands),
// and one __syncthreads a tile frees a stage for its next load.
//   S = Q.K^T: wgmma m64n128k16, A = Q and B = K from shared memory, both
//     K-major (contiguous along Dh); Dh/16 k-steps advance the descriptors'
//     start address by 32 bytes within the swizzle row.
//   Softmax on the accumulator in registers: a thread holds 2 rows (r and
//     r + 8) x 32 columns; the row max reduces over the 4 lanes of a quad
//     with shuffles; the row sum stays per thread until the end.  Only
//     tiles that cross the diagonal or the sequence end take the masked
//     code path; tiles wholly above the diagonal are never loaded.
//   O += P.V: P rounded to bf16 in registers is wgmma's A operand (the
//     m64nN accumulator layout is the A-fragment layout of the next
//     product); B = V from shared memory is MN-major (contiguous along Dh),
//     so the transpose-B bit is set: 8 k-steps of 16 keys, 2048 bytes
//     apart, a padded width of 128 reaching its second box through the
//     descriptor's leading byte offset.  O is rescaled by alpha in
//     registers before the product.
//   wgmma.fence precedes each batch of products; commit and wait_group 0
//     follow it, and an empty asm on every accumulator register keeps the
//     compiler from touching them while a product is in flight.
//   Epilogue: 1/max(l, 1e-30), rounded to bf16, stored as bf16 pairs to
//     the contiguous output (Dh columns, row stride H * Dh); rows past S
//     (a 64-row remainder tile, loaded as TMA's zero fill) are not stored.
// At DP = 64 a thread needs 128 registers, so two CTAs share an SM and one
// CTA's softmax overlaps the other's products; at DP = 128 (168 registers)
// one CTA runs an SM.  No producer warp, no setmaxnreg and no overlap of a
// warpgroup's own softmax with its products yet: later steps.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns 0, a CUDA error code, or minus the
// CUresult of a failed cuTensorMapEncodeTiled.  The driver's encoder is
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;             // two consumer warpgroups
constexpr int kBlockM = 128;              // query rows per CTA, 64 a warpgroup
constexpr int kBlockN = 128;              // keys per K/V tile
constexpr int kBoxCols = 64;              // bf16 columns per TMA box: 128 bytes
constexpr int kRowBytes = kBoxCols * 2;   // one swizzled row
constexpr int kBoxBytes = kBlockN * kRowBytes;  // 16 KB (kBlockM == kBlockN)
static_assert(kBlockM == kBlockN, "Q boxes and K/V boxes share one size");
constexpr float kLog2e = 1.4426950408889634f;

// The padded width of a head dim: a whole number of 64-column boxes.
template <int DH>
__host__ __device__ constexpr int padded() {
  return (DH + kBoxCols - 1) / kBoxCols * kBoxCols;
}

// Shared memory, from a 1024-byte aligned base: Q, two K stages, two V
// stages (each DP / 64 boxes), then the mbarriers: Q, K[2], V[2].
template <int DP>
struct Smem {
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kTile = kBoxes * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + 2 * kTile;
  static constexpr int kBars = kV + 2 * kTile;
  static constexpr int kBytes = kBars + 5 * 8 + 1024;  // + slack to align the base
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive once and expect `bytes` from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase with the given parity has completed.  A load that
// never lands traps after ~4M polls (seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int polls = 0; !mbar_try_wait(bar, parity); ++polls)
    if (polls > (1 << 22)) __trap();
}

// One TMA box of a 4-D map, coordinates innermost first: (col, head, row, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers at this point of the program: the compiler may not move a
// read or write of them across it (so none crosses an in-flight wgmma).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64, 128] (+)= A[64, 16] . B[128, 16]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64, 64] += A[64, 16] . B[16, 64], A in registers (bf16 pairs), B MN-major in
// shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D[64, 128] += A[64, 16] . B[16, 128], A in registers (bf16 pairs), B MN-major in
// shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// 2^x on the MUFU unit: ex2.approx.ftz, relative error about 2^-22,
// subnormal results flushed to 0 (2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The two rows' maxima of a tile's raw scores s[4c + e] (row row0 + 8 * (e / 2),
// key k0 + 8c + col_lane + e % 2); with kMask, keys past seq_k or above the
// diagonal first become -inf.
template <bool kMask>
__device__ __forceinline__ void tile_max(float (&s)[64], float& mx0, float& mx1, int k0, int row0,
                                         int col_lane, int seq_k, int causal) {
  mx0 = mx1 = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (kMask) {
      const int col = k0 + 8 * (i / 4) + col_lane + (i & 1);
      const int row = row0 + ((i & 2) ? 8 : 0);
      if (col >= seq_k || (causal && col > row)) s[i] = -CUDART_INF_F;
    }
    if (i & 2)
      mx1 = fmaxf(mx1, s[i]);
    else
      mx0 = fmaxf(mx0, s[i]);
  }
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc_b) {
  wgmma_m64n64k16_rs(o, a0, a1, a2, a3, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t desc_b) {
  wgmma_m64n128k16_rs(o, a0, a1, a2, a3, desc_b);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                  int seq_q, int seq_k, int heads, int group, float scale_log2, int causal) {
  constexpr int DP = padded<DH>();
  using L = Smem<DP>;
  constexpr int kBoxes = L::kBoxes;
  constexpr int kAcc = DP / 2;  // O floats per thread: 64 rows x DP over 128 threads
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ;
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_k = bar_q + 8;   // + 8 * stage
  const uint32_t bar_v = bar_q + 24;  // + 8 * stage

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wg_row0 = q0 + 64 * wg;
  const int row0 = wg_row0 + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col_lane = 2 * (lane % 4);

  // Key tiles holding a column <= the CTA's last row (all when not causal).
  const int last_row = min(q0 + kBlockM, seq_q) - 1;
  const int k_end = causal ? min(seq_k, last_row + 1) : seq_k;
  const int n_tiles = (k_end + kBlockN - 1) / kBlockN;

  auto load_kv = [&](int j) {
    const int stage = j & 1;
    const uint32_t kb = bar_k + 8 * stage, vb = bar_v + 8 * stage;
    mbar_expect_tx(kb, L::kTile);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
      tma_load(k_s + stage * L::kTile + x * kBoxBytes, &k_map, kb, x * kBoxCols, hk,
               j * kBlockN, b);
    mbar_expect_tx(vb, L::kTile);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
      tma_load(v_s + stage * L::kTile + x * kBoxBytes, &v_map, vb, x * kBoxCols, hk,
               j * kBlockN, b);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
      tma_load(q_s + x * kBoxBytes, &q_map, bar_q, x * kBoxCols, h, q0, b);
    load_kv(0);
  }
  __syncwarp();

  float o[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;                      // this thread's share of the row sums
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    const uint32_t parity = (j >> 1) & 1;
    if (tid == 0 && j + 1 < n_tiles) load_kv(j + 1);  // its stage was freed last tile
    __syncwarp();

    // S = Q.K^T for this warpgroup's 64 rows x 128 keys (the real Dh only).
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    mbar_wait(bar_k + 8 * stage, parity);
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t qa = q_s + (kk / 4) * kBoxBytes + wg * 64 * kRowBytes + (kk % 4) * 32;
      const uint32_t ka = k_s + stage * L::kTile + (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_m64n128k16_ss(s, sw128_desc(qa, 16, 8 * kRowBytes), sw128_desc(ka, 16, 8 * kRowBytes),
                          kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // Online softmax on the fragment: s[4c + e] is row row0 + 8 * (e / 2),
    // key k0 + 8c + col_lane + e % 2.  Only a tile that crosses the
    // diagonal or the sequence end takes the masked path.
    const int k0 = j * kBlockN;
    float mx0, mx1;
    if (k0 + kBlockN > seq_k || (causal && k0 + kBlockN - 1 > wg_row0))
      tile_max<true>(s, mx0, mx1, k0, row0, col_lane, seq_k, causal);
    else
      tile_max<false>(s, mx0, mx1, k0, row0, col_lane, seq_k, causal);
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
    // A row with no key yet keeps max -inf: subtract 0 so 2^x gives 0, not NaN.
    const float ms0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float ms1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float alpha0 = ex2(m0 - ms0), alpha1 = ex2(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    uint32_t p[32];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const float ms = (i & 2) ? ms1 : ms0;
      const float e0 = ex2(fmaf(s[i], scale_log2, -ms));
      const float e1 = ex2(fmaf(s[i + 1], scale_log2, -ms));
      if (i & 2)
        sum1 += e0 + e1;
      else
        sum0 += e0 + e1;
      p[i / 2] = pack_bf16(e0, e1);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;

    // O += P.V: k-step kk takes keys 16kk .. 16kk + 15, i.e. p[4kk .. 4kk + 3].
    mbar_wait(bar_v + 8 * stage, parity);
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t va = v_s + stage * L::kTile + kk * 16 * kRowBytes;
      wgmma_pv<DP>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                   sw128_desc(va, kBoxBytes, 8 * kRowBytes));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    __syncthreads();  // both warpgroups are done with this stage
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // out is contiguous [B, S, H, DH]; o[4c + e] is column 8c + col_lane + e % 2,
  // and columns DH .. DP - 1 (padding) are not stored.
  __nv_bfloat16* o0 = out + ((static_cast<long long>(b) * seq_q + row0) * heads + h) * DH;
  __nv_bfloat16* o1 = o0 + 8ll * heads * DH;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    if (row0 < seq_q)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * c + col_lane) =
          __floats2bfloat162_rn(o[4 * c] * inv0, o[4 * c + 1] * inv0);
    if (row0 + 8 < seq_q)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * c + col_lane) =
          __floats2bfloat162_rn(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (Dh, heads, rows, batch) of a bf16 tensor with strides in
// elements, boxes of 64 columns x 1 head x 128 rows x 1 batch, 128-byte
// swizzle, zero fill past the edges.  Returns 0 or minus a CUresult.
int make_map(CUtensorMap* map, const void* ptr, int dh, int heads, int rows, int batch,
             long long stride_h, long long stride_s, long long stride_b) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride_h) * 2,
                                 static_cast<cuuint64_t>(stride_s) * 2,
                                 static_cast<cuuint64_t>(stride_b) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kBlockN, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

template <int DH>
int launch(void* out, const void* q, const void* k, const void* v, const long long* qs,
           const long long* ks, const long long* vs, int batch, int seq_q, int seq_k, int heads,
           int kv_heads, float scale, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, q, DH, heads, seq_q, batch, qs[2], qs[1], qs[0]);
  if (err == 0) err = make_map(&k_map, k, DH, kv_heads, seq_k, batch, ks[2], ks[1], ks[0]);
  if (err == 0) err = make_map(&v_map, v, DH, kv_heads, seq_k, batch, vs[2], vs[1], vs[0]);
  if (err != 0) return err;
  const int smem = Smem<padded<DH>()>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_sm90_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((seq_q + kBlockM - 1) / kBlockM, heads, batch);
  flash_sm90_kernel<DH><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), seq_q, seq_k, heads,
      heads / kv_heads, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only; head_dim 16, 32, 64, 80, 112 or 128.  Strides are in elements.
extern "C" int flash_attention_sm90_fwd(void* out, const void* q, const void* k, const void* v,
                                        long long q_sb, long long q_ss, long long q_sh,
                                        long long k_sb, long long k_ss, long long k_sh,
                                        long long v_sb, long long v_ss, long long v_sh,
                                        int batch, int seq_q, int seq_k, int heads, int kv_heads,
                                        int head_dim, float scale, int causal, void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh}, vs[3] = {v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, s);
    case 32: return launch<32>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, s);
    case 64: return launch<64>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, s);
    case 80: return launch<80>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, s);
    case 112: return launch<112>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, s);
    case 128: return launch<128>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
