// Decode attention (one query token per sequence against a ring KV cache),
// hand-written for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel decode_attention
// (src/repro/kernels/flash_decode/kernel.py, _decode_kernel):
//   out[b, hk*G + g] = softmax_{w < count[b]}(q[b, hk*G + g] . k[b, w, hk] * scale) v[b, w, hk]
// with the softmax's running max, sum and accumulator in float32, cache
// rows at or past count[b] never read, and count[b] == 0 giving zeros (the
// TPU kernel skips every block and divides a zero accumulator by
// max(l, 1e-30)).
//
// Layout: q and out [B, H, Dh] contiguous; k and v [B, W, Hkv, Dh] read
// through their batch, row and head strides in elements (last axis
// contiguous), so the cache is read where it lies, whatever the batch
// stride of the view the serving VM hands over.  Inputs are float32 or
// bf16; arithmetic is float32; the output is rounded once to q's type.
//
// Bound: bytes.  A step reads q, the K and V rows below count and writes
// out: about 2*sum_b(count[b])*Hkv*Dh*s bytes of cache for 4*H*Dh FLOPs per
// cache row and group, ~G/s FLOPs per byte, far below the card's balance.
//
// Design (simple, right first): one CTA of 128 threads per (hk, b), so the
// G query heads of a group share every K/V byte read from device memory.
// The CTA walks the cache in tiles of 32 rows up to count[b] only,
// staging K and V as float32 in shared memory (rows padded by one word;
// each thread issues all its loads of a tile before storing any);
// thread (g, c) computes one score, one warp per query head does the
// online-softmax update with shuffles, and every thread then updates its
// accumulator entries (g, d) with the tile's P.V.  At the serving shape
// (B = 64, Hkv = 3) the grid is 192 CTAs on 132 SMs; splitting W across
// CTAs and combining the partial (m, l, acc) triples is a later step.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 32;
constexpr int kMaxGroup = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct CacheStrides {
  long long b, w, h;  // elements; the head-dim axis is contiguous
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_kernel(T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ count, CacheStrides ks,
              CacheStrides vs, int window, int heads, int group, float scale) {
  constexpr int kAcc = (kMaxGroup * DH + kThreads - 1) / kThreads;
  constexpr int kLoads = kBlockK * DH / kThreads;  // K (and V) elements per thread per tile
  static_assert(kBlockK * DH % kThreads == 0, "a tile must split evenly over the threads");
  __shared__ float q_s[kMaxGroup][DH];
  __shared__ float k_s[kBlockK][DH + 1];
  __shared__ float v_s[kBlockK][DH + 1];
  __shared__ float p_s[kMaxGroup][kBlockK];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n = min(max(count[b], 0), window);

  const T* q_base = q + (static_cast<long long>(b) * heads + hk * group) * DH;
  for (int e = tid; e < group * DH; e += kThreads) q_s[e / DH][e % DH] = to_f32(q_base[e]);
  if (tid < group) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;

  const T* k_base = k + b * ks.b + hk * ks.h;
  const T* v_base = v + b * vs.b + hk * vs.h;
  for (int w0 = 0; w0 < n; w0 += kBlockK) {
    __syncthreads();  // q staged; the previous tile is no longer read
    // Issue every load of the tile before the first store, so a thread
    // keeps 2 * kLoads reads in flight instead of waiting on each in turn.
    float kr[kLoads], vr[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int row = w0 + e / DH;
      const int d = e % DH;
      kr[i] = row < n ? to_f32(k_base[static_cast<long long>(row) * ks.w + d]) : 0.f;
      vr[i] = row < n ? to_f32(v_base[static_cast<long long>(row) * vs.w + d]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      k_s[e / DH][e % DH] = kr[i];
      v_s[e / DH][e % DH] = vr[i];
    }
    __syncthreads();

    for (int e = tid; e < group * kBlockK; e += kThreads) {
      const int g = e / kBlockK;
      const int c = e - g * kBlockK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s = fmaf(q_s[g][d], k_s[c][d], s);
      p_s[g][c] = w0 + c < n ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < group; g += kWarps) {
      const float s = p_s[g][lane];  // kBlockK == 32: one column per lane
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[g][lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int e = tid + r * kThreads;
      if (e < group * DH) {
        const int g = e / DH;
        const int d = e - g * DH;
        float a = acc[r] * alpha_s[g];
#pragma unroll 8
        for (int c = 0; c < kBlockK; ++c) a = fmaf(p_s[g][c], v_s[c][d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

  T* o = out + (static_cast<long long>(b) * heads + hk * group) * DH;
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int e = tid + r * kThreads;
    if (e < group * DH) o[e] = from_f32<T>(acc[r] / fmaxf(l_s[e / DH], 1e-30f));
  }
}

template <typename T, int DH>
int launch(void* out, const void* q, const void* k, const void* v, const void* count,
           CacheStrides ks, CacheStrides vs, int batch, int window, int heads, int kv_heads,
           float scale, cudaStream_t stream) {
  const dim3 grid(kv_heads, batch);
  decode_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(count), ks, vs, window, heads,
      heads / kv_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int head_dim, void* out, const void* q, const void* k, const void* v,
                const void* count, CacheStrides ks, CacheStrides vs, int batch, int window,
                int heads, int kv_heads, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(out, q, k, v, count, ks, vs, batch, window, heads, kv_heads, scale, stream);
    case 32: return launch<T, 32>(out, q, k, v, count, ks, vs, batch, window, heads, kv_heads, scale, stream);
    case 64: return launch<T, 64>(out, q, k, v, count, ks, vs, batch, window, heads, kv_heads, scale, stream);
    case 128: return launch<T, 128>(out, q, k, v, count, ks, vs, batch, window, heads, kv_heads, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.
extern "C" int flash_decode_fwd(void* out, const void* q, const void* k, const void* v,
                                const void* count, long long k_sb, long long k_sw,
                                long long k_sh, long long v_sb, long long v_sw, long long v_sh,
                                int batch, int window, int heads, int kv_heads, int head_dim,
                                float scale, int dtype, void* stream) {
  if (batch <= 0 || window <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      heads / kv_heads > kMaxGroup || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const CacheStrides ks{k_sb, k_sw, k_sh}, vs{v_sb, v_sw, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dh<float>(head_dim, out, q, k, v, count, ks, vs, batch, window, heads, kv_heads, scale, s);
    case 1: return dispatch_dh<__nv_bfloat16>(head_dim, out, q, k, v, count, ks, vs, batch, window, heads, kv_heads, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
