// Decode attention (one query token per sequence against a ring KV cache),
// hand-written for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel decode_attention
// (src/repro/kernels/flash_decode/kernel.py, _decode_kernel):
//   out[b, hk*G + g] = softmax_{w < count[b]}(q[b, hk*G + g] . k[b, w, hk] * scale) v[b, w, hk]
// with the softmax's running max, sum and accumulator in float32 (the bf16
// path rounds P to bf16 for its product, at most 2^-9 a term), cache
// rows at or past count[b] never read, and count[b] == 0 giving zeros (the
// TPU kernel skips every block and divides a zero accumulator by
// max(l, 1e-30)).
//
// Layout: q and out [B, H, Dh] contiguous; k and v [B, W, Hkv, Dh] read
// through their batch, row and head strides in elements (last axis
// contiguous), so the cache is read where it lies, whatever the batch
// stride of the view the serving VM hands over.  Inputs are float32 or
// bf16; arithmetic is float32; the output is rounded once to q's type.
// Every cache load is 16 bytes, so the wrapper checks that the base
// pointers and the batch, row and head strides are multiples of 16 bytes,
// and raises otherwise.
//
// Bound: bytes.  A step reads q, the K and V rows below count and writes
// out: about 2*sum_b(count[b])*Hkv*Dh*s bytes of cache for 4*H*Dh FLOPs per
// cache row, ~G/s FLOPs per byte, far below the card's balance.  Two things
// stand between a kernel and that bound: bytes in flight (~25 KB an SM to
// cover the memory latency at 3.35 TB/s) and, at G = 3, instructions: with
// CUDA-core FMAs the lanes that share a row spend more on shuffles,
// exponentials and bookkeeping than on the products, and the kernel runs
// no faster when its loads are removed.
//
// Design: split the window (split-K, the combine the TPU kernel's
// docstring describes for long contexts).  The grid is (Hkv, B, splits),
// splits = ceil(W / 64) fixed by W (count stays on the device).  A CTA of
// 4 warps takes one chunk of 64 rows, 16 a warp; a chunk that starts at or
// past count[b] exits at once.  Every K and V row of the chunk is staged in
// shared memory with 16-byte cp.async copies (rows at or past count are
// zero-filled, not read), all issued before the first use and holding no
// registers while in flight: 16 KB a CTA at bf16, Dh = 64.
//   bf16: each warp runs its 16 rows on the tensor cores (mma.sync
//     m16n8k16; decode_split_mma_kernel), the G <= 16 query rows padded
//     to 16.
//   float32: CUDA-core FMAs (decode_split_kernel); Dh / 4 lanes, rounded
//     up to a power of two, share a row, reduce q.k with shuffles and
//     keep the warp's online softmax.
// Head dims 16, 32, 64, 80, 112 and 128; groups of up to 16 query heads.
// One __syncthreads merges the 4 warps' (m, l, acc) through shared memory.
// With one split the CTA writes the output; otherwise it writes its
// partial (acc[G, Dh], m, l) in float32 to a scratch buffer the wrapper
// allocates, and a second kernel, one CTA per (hk, b), combines the splits
// below count (none when count == 0, which gives zeros).
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                     // cache rows per CTA
constexpr int kRowsPerWarp = kChunk / kWarps;  // 16
constexpr int kMaxGroup = 16;  // query heads per KV head
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct CacheStrides {
  long long b, w, h;  // elements; the head-dim axis is contiguous
};

__host__ __device__ constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }

// How a warp of the float32 path covers its rows with 16-byte loads.  A
// row takes a power of two of lanes; at a head dim that is not a power of
// two (80, 112) the lanes past the row's last 16-byte piece idle: they
// load nothing (zero-filled), hold a zero query and add zeros to the
// shuffled sums.  With 16 query rows a pass takes one cache row, to keep
// the per-row scores in registers.
template <int DH, int MG>
struct Tiling {
  static constexpr int kVec = 4;                              // floats per load
  static constexpr int kLanesUsed = DH / kVec;                // 4 .. 32 lanes load a row
  static constexpr int kLanesPerRow = pow2_ceil(kLanesUsed);  // lanes a row takes
  static constexpr int kRowsPerStep = 32 / kLanesPerRow;      // rows a warp loads at once
  static constexpr int kSteps = kRowsPerWarp / kRowsPerStep;  // loads per thread per chunk
  static constexpr int kPass = MG > 8 ? 1 : kSteps < 4 ? kSteps : 4;  // rows per softmax update
  static constexpr int kPasses = kSteps / kPass;
  static_assert(DH % kVec == 0 && kLanesPerRow <= 32 && kSteps % kPass == 0,
                "unsupported head dim");
};

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[4]) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 reads nothing
// and zero-fills.
__device__ __forceinline__ void cp_async16_addr(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  cp_async16_addr(static_cast<uint32_t>(__cvta_generic_to_shared(dst)), src, src_bytes);
}

// The chunk's result from its warps' (m, l, acc) in shared memory (m in
// log2 units): the output when there is one split, else the chunk's
// partial (acc[G, Dh], m, l) for the combine.
template <typename T, int DH, int MG>
__device__ __forceinline__ void merge_warps(T* __restrict__ out, float* __restrict__ part,
                                            const float (&m_s)[kWarps][MG],
                                            const float (&l_s)[kWarps][MG],
                                            const float (&acc_s)[kWarps][MG][DH],
                                            long long out_row, int group, int splits,
                                            long long bh, int split) {
  for (int e = threadIdx.x; e < group * DH; e += kThreads) {
    const int g = e / DH;
    const int d = e - g * DH;
    float mx = m_s[0][g];  // finite: the chunk's first row is below count
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_s[w][g] - mx);
      lsum = fmaf(l_s[w][g], f, lsum);
      a = fmaf(acc_s[w][g][d], f, a);
    }
    if (splits == 1) {
      out[(out_row + g) * DH + d] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
    } else {
      float* p = part + ((bh * splits + split) * group + g) * (DH + 2);
      p[d] = a;
      if (d == 0) {
        p[DH] = mx;
        p[DH + 1] = lsum;
      }
    }
  }
}

// float32 on the CUDA cores: one chunk of one (hk, b), MG >= group query
// heads in registers.  Each
// thread stages its 16-byte pieces of the chunk's K and V rows in shared
// memory with cp.async (no registers held while they are in flight) and
// reads back only its own pieces, so no barrier guards the staging.
template <int DH, int MG>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(float* __restrict__ out, float* __restrict__ part, const float* __restrict__ q,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const int32_t* __restrict__ count, CacheStrides ks, CacheStrides vs,
                    int window, int heads, int group, int splits, float scale_log2) {
  using Tl = Tiling<DH, MG>;
  constexpr int kVec = Tl::kVec;
  extern __shared__ uint4 staged[];  // [K, V][kSteps][kThreads]
  __shared__ float m_s[kWarps][MG], l_s[kWarps][MG];
  __shared__ float acc_s[kWarps][MG][DH];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int n = min(max(count[b], 0), window);
  const int w0 = split * kChunk;
  const long long out_row = static_cast<long long>(b) * heads + hk * group;
  if (w0 >= n) {  // nothing to read: the combine skips this split
    if (splits == 1)
      for (int e = tid; e < group * DH; e += kThreads) out[out_row * DH + e] = 0.f;
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int piece = lane % Tl::kLanesPerRow;
  const bool active = piece < Tl::kLanesUsed;   // a lane past the row's end idles
  const int col = active ? piece * kVec : 0;    // this lane's columns: col .. col + kVec - 1
  const int slot = lane / Tl::kLanesPerRow;     // its row within a step
  auto row_of = [&](int step) {
    return w0 + warp * kRowsPerWarp + step * Tl::kRowsPerStep + slot;
  };

  // Every load of the chunk goes out before the first use.
  const float* k_base = k + b * ks.b + hk * ks.h + col;
  const float* v_base = v + b * vs.b + hk * vs.h + col;
  uint4* k_st = staged + tid;
  uint4* v_st = staged + Tl::kSteps * kThreads + tid;
#pragma unroll
  for (int step = 0; step < Tl::kSteps; ++step) {
    const int row = row_of(step);
    const bool live = active && row < n;
    cp_async16(k_st + step * kThreads, live ? k_base + row * ks.w : k_base, live ? 16 : 0);
    cp_async16(v_st + step * kThreads, live ? v_base + row * vs.w : v_base, live ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  uint4 q_raw[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g)
    q_raw[g] = g < group && active
                   ? *reinterpret_cast<const uint4*>(q + (out_row + g) * DH + col)
                   : make_uint4(0, 0, 0, 0);
  float qf[MG][kVec];
#pragma unroll
  for (int g = 0; g < MG; ++g) unpack(q_raw[g], qf[g]);

  float m[MG], l[MG], acc[MG][kVec];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int pass = 0; pass < Tl::kPasses; ++pass) {
    // Scores: each lane's partial dot over its columns, summed over the
    // lanes of the row.
    float sc[Tl::kPass][MG];
#pragma unroll
    for (int i = 0; i < Tl::kPass; ++i) {
      const int step = pass * Tl::kPass + i;
      float kf[kVec];
      unpack(k_st[step * kThreads], kf);
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) s = fmaf(qf[g][e], kf[e], s);
#pragma unroll
        for (int off = 1; off < Tl::kLanesPerRow; off *= 2)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        sc[i][g] = row_of(step) < n ? s * scale_log2 : -CUDART_INF_F;
      }
    }

    // The warp's online softmax over the pass's rows (log2 units).
    float p[Tl::kPass][MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int i = 1; i < Tl::kPass; ++i) mx = fmaxf(mx, sc[i][g]);
#pragma unroll
      for (int off = Tl::kLanesPerRow; off < 32; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // no live row yet
      const float alpha = exp2f(m[g] - m_use);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < Tl::kPass; ++i) {
        p[i][g] = exp2f(sc[i][g] - m_use);
        l[g] += p[i][g];
      }
    }
#pragma unroll
    for (int i = 0; i < Tl::kPass; ++i) {
      float vf[kVec];
      unpack(v_st[(pass * Tl::kPass + i) * kThreads], vf);
#pragma unroll
      for (int g = 0; g < MG; ++g)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(p[i][g], vf[e], acc[g][e]);
    }
  }

  // Sum l and acc over the warp's row slots, then merge the warps.
#pragma unroll
  for (int g = 0; g < MG; ++g) {
#pragma unroll
    for (int off = Tl::kLanesPerRow; off < 32; off *= 2) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  }
  if (slot == 0 && active) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc_s[warp][g][col + e] = acc[g][e];
      if (lane == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  merge_warps<float, DH, MG>(out, part, m_s, l_s, acc_s, out_row, group, splits,
                         static_cast<long long>(b) * gridDim.x + hk, split);
}

// bf16 on the tensor cores: mma.sync m16n8k16 (bf16 in, float32 out) with
// the group's G <= 16 query rows as the 16-row A operand (rows G..15 zero;
// with MG = 8 rows 8..15 are not even loaded or softmaxed).
// Each warp takes 16 cache rows of the chunk: S[16, 16] = Q.K^T in two
// n-blocks, its online-softmax state for its 16 rows, and O[16, Dh] +=
// P.V with P in registers (the accumulator layout of S is the A-fragment
// layout of P), so a cache row costs a few instructions instead of the
// CUDA-core path's ~90 a lane.  K and V reach the fragments through
// ldmatrix from shared memory, each 16-byte piece at column (c ^ row % 8)
// so that the 8 rows one ldmatrix reads fall in different banks; a staged
// row takes a multiple of 8 pieces (16 at Dh 80 and 112, whose 10 and 14
// pieces would otherwise swizzle past the row's end).  P is rounded to
// bf16 for the product (at most 2^-9 relative a term).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a . b for one m16n8k16 tile: a0, a2 hold row g of a, a1, a3 row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16-byte pieces a staged bf16 row takes: its Dh / 8, rounded up to the
// 8-piece swizzle.
__host__ __device__ constexpr int staged_pitch(int dh) { return dh / 8 < 8 ? dh / 8 : (dh / 8 + 7) / 8 * 8; }

// The warp's softmax over its 16 rows for one query row: s[nb][i0], s[nb][i0 + 1]
// (a quad's lanes share the row); s becomes P, returns (max, sum) in log2 units.
__device__ __forceinline__ float2 quad_softmax(float (&s)[2][4], int i0, int row0, int kq,
                                               int n, float scale_log2) {
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = row0 + 8 * nb + kq + e < n;
      s[nb][i0 + e] = live ? s[nb][i0 + e] * scale_log2 : -CUDART_INF_F;
      mx = fmaxf(mx, s[nb][i0 + e]);
    }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_use = mx == -CUDART_INF_F ? 0.f : mx;  // no live row in this warp
  float lsum = 0.f;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nb][i0 + e] = exp2f(s[nb][i0 + e] - m_use);
      lsum += s[nb][i0 + e];
    }
  lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
  lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
  return make_float2(mx, lsum);
}

template <int DH, int MG>
__global__ void __launch_bounds__(kThreads)
decode_split_mma_kernel(__nv_bfloat16* __restrict__ out, float* __restrict__ part,
                        const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ count,
                        CacheStrides ks, CacheStrides vs, int window, int heads, int group,
                        int splits, float scale_log2) {
  constexpr bool kHi = MG > 8;          // query rows 8..15 live
  constexpr int kPieces = DH / 8;       // 16-byte pieces a row
  constexpr int kSwz = kPieces < 8 ? kPieces : 8;
  constexpr int kPitch = staged_pitch(DH);
  constexpr int kWarpBytes = kRowsPerWarp * kPitch * 16;
  static_assert(DH % 16 == 0, "mma.sync takes the head dim in steps of 16");
  extern __shared__ uint4 staged[];     // [warp][K, V][16 rows][kPitch], swizzled
  __shared__ float m_s[kWarps][MG], l_s[kWarps][MG];
  __shared__ float acc_s[kWarps][MG][DH];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int n = min(max(count[b], 0), window);
  const int w0 = split * kChunk;
  const long long out_row = static_cast<long long>(b) * heads + hk * group;
  if (w0 >= n) {  // nothing to read: the combine skips this split
    if (splits == 1)
      for (int e = tid; e < group * DH; e += kThreads)
        out[out_row * DH + e] = __float2bfloat16(0.f);
    return;
  }
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = w0 + warp * kRowsPerWarp;  // the warp's first cache row

  // Stage the warp's 16 K and V rows, every load out before the first use.
  const uint32_t k_st = static_cast<uint32_t>(__cvta_generic_to_shared(staged)) + warp * 2 * kWarpBytes;
  const uint32_t v_st = k_st + kWarpBytes;
  const __nv_bfloat16* k_base = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* v_base = v + b * vs.b + hk * vs.h;
#pragma unroll
  for (int c = lane; c < kRowsPerWarp * kPieces; c += 32) {
    const int r = c / kPieces, piece = c % kPieces;
    const int row = row0 + r;
    const bool live = row < n;
    const uint32_t off = (r * kPitch + (piece ^ (r % kSwz))) * 16;
    cp_async16_addr(k_st + off, live ? k_base + row * ks.w + piece * 8 : k_base, live ? 16 : 0);
    cp_async16_addr(v_st + off, live ? v_base + row * vs.w + piece * 8 : v_base, live ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // Q as the A operand: a0 = (g, 16kk + 2(lane%4) + {0,1}), a2 = the same
  // + 8 columns; a1, a3 the same for query row g + 8.
  const int g = lane / 4;
  const int kq = 2 * (lane % 4);
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = g + 8 * hi;
      const bool live = (hi == 0 || kHi) && row < group;
      const __nv_bfloat16* qr = q + (out_row + row) * DH + 16 * kk + kq;
      qa[kk][hi] = live ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
      qa[kk][hi + 2] = live ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  // ldmatrix row addresses: lane l reads row (l % 8) + 8 * (l / 16) of the
  // warp's 16 for K (matrices: rows 0-7 / 8-15 x pieces p, p + 1), and row
  // (l % 16) for V (rows 0-7, 8-15 x pieces p, then p + 1).
  const int kr = (lane % 8) + 8 * (lane / 16), kp = (lane / 8) % 2;
  const int vr = lane % 16, vp = lane / 16;
  auto at = [&](uint32_t base, int r, int piece) {
    return base + (r * kPitch + (piece ^ (r % kSwz))) * 16;
  };

  // S = Q.K^T: s[nb] holds query rows g (c0, c1) and g + 8 (c2, c3) for
  // cache rows 8nb + 2(lane%4) + {0, 1}.
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t kb[4];  // b0, b1 of n-block 0, then of n-block 1
    ldmatrix_x4(kb, at(k_st, kr, 2 * kk + kp));
    mma_bf16(s[0], qa[kk], kb[0], kb[1]);
    mma_bf16(s[1], qa[kk], kb[2], kb[3]);
  }

  // The warp's softmax over its 16 rows for query rows g and g + 8.
  const float2 lo = quad_softmax(s, 0, row0, kq, n, scale_log2);
  const float2 hi = kHi ? quad_softmax(s, 2, row0, kq, n, scale_log2) : make_float2(0.f, 0.f);
  const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                          kHi ? pack_bf16(s[0][2], s[0][3]) : 0u,
                          pack_bf16(s[1][0], s[1][1]),
                          kHi ? pack_bf16(s[1][2], s[1][3]) : 0u};

  // O = P.V: d-blocks of 8 columns, two per ldmatrix.
  float o[DH / 8][4];
#pragma unroll
  for (int db = 0; db < DH / 8; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
#pragma unroll
  for (int db = 0; db < DH / 8; db += 2) {
    uint32_t vb[4];  // b0, b1 of d-block db, then of db + 1
    ldmatrix_x4_trans(vb, at(v_st, vr, db + vp));
    mma_bf16(o[db], pa, vb[0], vb[1]);
    mma_bf16(o[db + 1], pa, vb[2], vb[3]);
  }

  // Merge the warps: the same arithmetic as the CUDA-core path.
#pragma unroll
  for (int h = 0; h < (kHi ? 2 : 1); ++h) {
    const int row = g + 8 * h;
    if (row < group) {
#pragma unroll
      for (int db = 0; db < DH / 8; ++db) {
        acc_s[warp][row][8 * db + kq] = o[db][2 * h];
        acc_s[warp][row][8 * db + kq + 1] = o[db][2 * h + 1];
      }
      if (lane % 4 == 0) {
        m_s[warp][row] = h ? hi.x : lo.x;
        l_s[warp][row] = h ? hi.y : lo.y;
      }
    }
  }
  __syncthreads();
  merge_warps<__nv_bfloat16, DH, MG>(out, part, m_s, l_s, acc_s, out_row, group, splits,
                                     static_cast<long long>(b) * gridDim.x + hk, split);
}

// Merge the partials of the splits below count[b] for one (hk, b), in one
// online pass that loads the partials of kBatch splits before their first use.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(T* __restrict__ out, const float* __restrict__ part,
                      const int32_t* __restrict__ count, int window, int heads, int group,
                      int splits) {
  constexpr int kBatch = 8;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int n = min(max(count[b], 0), window);
  const int used = (n + kChunk - 1) / kChunk;
  const long long out_row = static_cast<long long>(b) * heads + hk * group;
  const float* base = part + static_cast<long long>(b * gridDim.x + hk) * splits * group * (DH + 2);
  for (int e = threadIdx.x; e < group * DH; e += kThreads) {
    const int g = e / DH;
    const int d = e - g * DH;
    float mx = -CUDART_INF_F, lsum = 0.f, a = 0.f;
    for (int s0 = 0; s0 < used; s0 += kBatch) {
      float pm[kBatch], pl[kBatch], pa[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const bool live = s0 + i < used;
        const float* p = base + static_cast<long long>((s0 + i) * group + g) * (DH + 2);
        pm[i] = live ? p[DH] : -CUDART_INF_F;
        pl[i] = live ? p[DH + 1] : 0.f;
        pa[i] = live ? p[d] : 0.f;
      }
      float m_new = mx;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) m_new = fmaxf(m_new, pm[i]);  // finite: split s0 is used
      const float alpha = exp2f(mx - m_new);
      lsum *= alpha;
      a *= alpha;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const float f = exp2f(pm[i] - m_new);
        lsum = fmaf(pl[i], f, lsum);
        a = fmaf(pa[i], f, a);
      }
      mx = m_new;
    }
    out[(out_row + g) * DH + d] = from_f32<T>(a / fmaxf(lsum, 1e-30f));  // 0 when count == 0
  }
}

// Opt a split kernel into more than 48 KB of shared memory when its
// dynamic (staged rows) and static (warp merge) parts need it.
template <typename Kernel>
int allow_smem(Kernel kernel, int dynamic_bytes, int group_max, int dh) {
  const int static_bytes = (2 * kWarps * group_max + kWarps * group_max * dh) * 4;
  if (dynamic_bytes + static_bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_bytes));
}

// After the split pass: the combine, when there is more than one split.
template <typename T, int DH>
int finish(void* out, const void* part, const void* count, int batch, int window, int heads,
           int kv_heads, int splits, cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  decode_combine_kernel<T, DH><<<dim3(kv_heads, batch), kThreads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const float*>(part), static_cast<const int32_t*>(count),
      window, heads, heads / kv_heads, splits);
  return static_cast<int>(cudaGetLastError());
}

// float32: the CUDA-core split pass, MG >= the group size.
template <int DH, int MG>
int launch_f32(void* out, void* part, const void* q, const void* k, const void* v,
               const void* count, CacheStrides ks, CacheStrides vs, int batch, int window,
               int heads, int kv_heads, int splits, float scale, cudaStream_t stream) {
  constexpr int kStaged = 2 * Tiling<DH, MG>::kSteps * kThreads * 16;  // K and V pieces
  const int err = allow_smem(decode_split_kernel<DH, MG>, kStaged, MG, DH);
  if (err != 0) return err;
  decode_split_kernel<DH, MG><<<dim3(kv_heads, batch, splits), kThreads, kStaged, stream>>>(
      static_cast<float*>(out), static_cast<float*>(part), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(count), ks, vs, window, heads, heads / kv_heads, splits,
      scale * kLog2e);
  return finish<float, DH>(out, part, count, batch, window, heads, kv_heads, splits, stream);
}

// bf16: the tensor-core split pass, MG >= the group size.
template <int DH, int MG>
int launch_bf16(void* out, void* part, const void* q, const void* k, const void* v,
                const void* count, CacheStrides ks, CacheStrides vs, int batch, int window,
                int heads, int kv_heads, int splits, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr int kStaged = kWarps * 2 * kRowsPerWarp * staged_pitch(DH) * 16;  // K and V rows
  const int err = allow_smem(decode_split_mma_kernel<DH, MG>, kStaged, MG, DH);
  if (err != 0) return err;
  decode_split_mma_kernel<DH, MG><<<dim3(kv_heads, batch, splits), kThreads, kStaged, stream>>>(
      static_cast<T*>(out), static_cast<float*>(part), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const int32_t*>(count), ks,
      vs, window, heads, heads / kv_heads, splits, scale * kLog2e);
  return finish<T, DH>(out, part, count, batch, window, heads, kv_heads, splits, stream);
}

template <int DH>
int dispatch(int dtype, void* out, void* part, const void* q, const void* k, const void* v,
             const void* count, CacheStrides ks, CacheStrides vs, int batch, int window,
             int heads, int kv_heads, int splits, float scale, cudaStream_t stream) {
  const int group = heads / kv_heads;
  if (dtype == 1 && group <= 8)
    return launch_bf16<DH, 8>(out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, stream);
  if (dtype == 1)
    return launch_bf16<DH, kMaxGroup>(out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, stream);
  if (group <= 2)
    return launch_f32<DH, 2>(out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, stream);
  if (group == 3)
    return launch_f32<DH, 3>(out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, stream);
  if (group <= 4)
    return launch_f32<DH, 4>(out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, stream);
  if (group <= 8)
    return launch_f32<DH, 8>(out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, stream);
  return launch_f32<DH, kMaxGroup>(out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  `part` is
// float32 scratch of batch * kv_heads * splits * (heads / kv_heads) *
// (head_dim + 2) values, unused when splits == 1; `chunk` must be the
// kernel's 64 rows and splits * chunk >= window.
extern "C" int flash_decode_fwd(void* out, void* part, const void* q, const void* k,
                                const void* v, const void* count, long long k_sb, long long k_sw,
                                long long k_sh, long long v_sb, long long v_sw, long long v_sh,
                                int batch, int window, int heads, int kv_heads, int head_dim,
                                int splits, int chunk, float scale, int dtype, void* stream) {
  if (batch <= 0 || window <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      heads / kv_heads > kMaxGroup || batch > 65535 || chunk != kChunk || splits <= 0 ||
      splits > 65535 || static_cast<long long>(splits) * kChunk < window)
    return static_cast<int>(cudaErrorInvalidValue);
  const CacheStrides ks{k_sb, k_sw, k_sh}, vs{v_sb, v_sw, v_sh};
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return dispatch<16>(dtype, out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, s);
    case 32: return dispatch<32>(dtype, out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, s);
    case 64: return dispatch<64>(dtype, out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, s);
    case 80: return dispatch<80>(dtype, out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, s);
    case 112: return dispatch<112>(dtype, out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, s);
    case 128: return dispatch<128>(dtype, out, part, q, k, v, count, ks, vs, batch, window, heads, kv_heads, splits, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
