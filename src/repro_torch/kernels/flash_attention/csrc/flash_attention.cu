// Causal GQA flash attention (prefill), hand-written for Hopper (sm_90a),
// with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py, _flash_kernel):
//   out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / G] * scale) v[b, t, h / G]
// over t <= s when causal (top-left alignment, rows >= cols), with the
// running max, sum and accumulator of an online softmax kept in float32
// and tiles wholly above the diagonal skipped.  G = H / Hkv query heads
// share one key/value head.
//
// Layout: q and out [B, S, H, Dh], k and v [B, T, Hkv, Dh] (the model's
// own layout, so no transpose is made), each read through its batch, row
// and head strides in elements with the last axis contiguous; out is
// contiguous.  Inputs are float32 or bf16; all arithmetic is float32 on
// CUDA cores (as the TPU kernel casts its tiles to f32) and the output is
// rounded once to the input type.
//
// Bound: operations.  The causal work is about 4*B*H*S*T*Dh/2 FLOPs over
// (B*S*H + 2*B*T*Hkv + B*S*H)*Dh*s bytes; at the prefill shape (B=8,
// S=T=2048, H=9, Dh=64) that is ~1.2 K FLOPs per byte, far above the
// H100's balance point, so the tensor cores would be the limit.
//
// Design (simple, right first): one CTA of 128 threads per (q-tile, h, b),
// 64 query rows by 64 keys per tile.  The CTA stages its query tile and,
// in turn, each key and value tile in shared memory as float32 (rows padded
// by one word against bank conflicts), loops over the key tiles up to the
// diagonal, and masks only the diagonal tile.  Thread (ty, tx) = (t / 8,
// t % 8) owns query rows 4*ty .. 4*ty + 3: it computes their scores for
// keys tx + 8*j (j < 8), reduces the row max and sum across the 8 lanes
// that share the rows with warp shuffles, and accumulates output columns
// tx + 8*j (j < Dh / 8) in registers, so m, l and the accumulator never
// leave the thread.  The probabilities go through shared memory once per
// tile for the P.V product.  Tiles are numbered so that the longest rows
// (the last query tiles, which see the most keys) start first.  No tensor
// cores, no TMA: wgmma and a producer warp are a later step.  Head dims
// 16, 32, 64, 80, 112 and 128 (any multiple of 8 would do: a thread owns
// Dh / 8 output columns); 80 and 112 are HuBERT-XLarge's and Zamba2-7B's.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRowsPerThread = 4;  // 16 row groups x 4 rows = 64
constexpr int kColLanes = 8;       // lanes sharing one row group
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;  // elements; the head-dim axis is contiguous
};

// Copy rows [row0, row0 + 64) of one head into a float32 tile [64][DH + 1];
// rows past `rows` are zero.
template <typename T, int DH>
__device__ void load_tile(float* tile, const T* __restrict__ base, long long row_stride,
                          int row0, int rows) {
  for (int e = threadIdx.x; e < kBlockK * DH; e += kThreads) {
    const int r = e / DH;
    const int d = e - r * DH;
    const int row = row0 + r;
    tile[r * (DH + 1) + d] =
        row < rows ? to_f32(base[static_cast<long long>(row) * row_stride + d]) : 0.f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, Strides qs, Strides ks, Strides vs, int seq_q, int seq_k,
             int heads, int group, float scale, int causal) {
  constexpr int kCols = DH / kColLanes;  // output columns per thread
  extern __shared__ float smem[];
  float* q_tile = smem;                            // [64][DH + 1]
  float* k_tile = q_tile + kBlockQ * (DH + 1);     // [64][DH + 1]
  float* v_tile = k_tile + kBlockK * (DH + 1);     // [64][DH + 1]
  float* p_tile = v_tile + kBlockK * (DH + 1);     // [64][64 + 1]

  const int num_q_tiles = gridDim.x;
  const int iq = num_q_tiles - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int ty = threadIdx.x / kColLanes;
  const int tx = threadIdx.x % kColLanes;
  const int q0 = iq * kBlockQ;

  const T* q_base = q + b * qs.b + h * qs.h + static_cast<long long>(q0) * qs.s;
  load_tile<T, DH>(q_tile, q_base, qs.s, 0, seq_q - q0);
  const T* k_base = k + b * ks.b + hk * ks.h;
  const T* v_base = v + b * vs.b + hk * vs.h;

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // Key tiles that hold a column <= the tile's last row (all when not causal).
  const int last_row = min(q0 + kBlockQ, seq_q) - 1;
  const int k_end = causal ? min(seq_k, last_row + 1) : seq_k;
  const int num_k_tiles = (k_end + kBlockK - 1) / kBlockK;

  for (int jt = 0; jt < num_k_tiles; ++jt) {
    const int k0 = jt * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, DH>(k_tile, k_base, ks.s, k0, seq_k);
    load_tile<T, DH>(v_tile, v_base, vs.s, k0, seq_k);
    __syncthreads();

    float s[kRowsPerThread][kColLanes];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColLanes; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[kRowsPerThread], kv[kColLanes];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = q_tile[(ty * kRowsPerThread + i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < kColLanes; ++j) kv[j] = k_tile[(tx + kColLanes * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColLanes; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    const bool diagonal = causal && k0 + kBlockK > q0;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = q0 + ty * kRowsPerThread + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kColLanes; ++j) {
        const int col = k0 + tx + kColLanes * j;
        float x = s[i][j] * scale;
        if (col >= seq_k || (diagonal && col > row)) x = kNegInf;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = kColLanes / 2; off > 0; off /= 2)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColLanes; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        p_tile[(ty * kRowsPerThread + i) * (kBlockK + 1) + tx + kColLanes * j] = p;
      }
#pragma unroll
      for (int off = kColLanes / 2; off > 0; off /= 2)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = p_tile[(ty * kRowsPerThread + i) * (kBlockK + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = v_tile[c * (DH + 1) + tx + kColLanes * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  // out is contiguous [B, S, H, DH].
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty * kRowsPerThread + i;
    if (row >= seq_q) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * seq_q + row) * heads + h) * DH;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[tx + kColLanes * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int DH>
int launch(void* out, const void* q, const void* k, const void* v, Strides qs, Strides ks,
           Strides vs, int batch, int seq_q, int seq_k, int heads, int kv_heads, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * kBlockQ * (DH + 1) + kBlockQ * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qs, ks, vs, seq_q, seq_k, heads, heads / kv_heads, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int head_dim, void* out, const void* q, const void* k, const void* v, Strides qs,
                Strides ks, Strides vs, int batch, int seq_q, int seq_k, int heads, int kv_heads,
                float scale, int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, stream);
    case 32: return launch<T, 32>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, stream);
    case 64: return launch<T, 64>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, stream);
    case 80: return launch<T, 80>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, stream);
    case 112: return launch<T, 112>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, stream);
    case 128: return launch<T, 128>(out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.
extern "C" int flash_attention_fwd(void* out, const void* q, const void* k, const void* v,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   int batch, int seq_q, int seq_k, int heads, int kv_heads,
                                   int head_dim, float scale, int causal, int dtype,
                                   void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dh<float>(head_dim, out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, s);
    case 1: return dispatch_dh<__nv_bfloat16>(head_dim, out, q, k, v, qs, ks, vs, batch, seq_q, seq_k, heads, kv_heads, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
