// Batched per-lane stack traffic of the program-counter VM (paper Alg. 2),
// hand-written for Hopper (sm_90a) with a plain C interface for ctypes.
//
// stack_ops_push replaces the Pallas TPU kernel masked_push
// (src/repro/kernels/stack_ops/kernel.py, _push_kernel): for every lane z
// with mask[z] and 0 <= ptr[z] < D it writes val[z, :] into
// stack[ptr[z], z, :], in place; every other row is left untouched.
// stack_ops_peek replaces masked_peek (same file, _peek_kernel):
// out[z, :] = stack[clamp(ptr[z], 0, D - 1), z, :].
//
// Layout: stack [D, Z, F], val/out [Z, F], ptr [Z] int32, mask [Z] bool,
// all contiguous.  The kernels copy element bits and never interpret them,
// so one template per element size (1, 2, 4, 8 bytes) serves bool, bf16,
// float32, int32 and the int32 words of the PRNG keys alike.
//
// Bound: memory bytes; neither kernel does arithmetic worth counting
// (s = element size).  The peek reads one stack row and writes one output
// row per lane, 2*Z*F*s bytes, plus 4*Z of pointer.  The push reads val and
// writes the stack only for the W lanes it writes, 2*W*F*s bytes, plus 5*Z
// of pointer and mask, so at most 2*Z*F*s + 5*Z.  The design is
// one 1-D grid over the Z*F elements, element e -> lane z = e / F, feature
// f = e % F, so neighbouring threads touch neighbouring bytes of one lane's
// row and each warp's accesses coalesce within a row.  At the VM's sizes
// (Z = 1024 lanes, F <= 100) a launch moves well under a megabyte, so in
// practice it is bound by launch overhead, not bandwidth; capturing the
// dispatch loop in CUDA graphs is the lever for that, not this kernel.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() so that a refused
// launch is reported to the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void push_kernel(T* __restrict__ stack, const int32_t* __restrict__ ptr,
                            const uint8_t* __restrict__ mask, const T* __restrict__ val,
                            int depth, int lanes, int feat) {
  const long long n = static_cast<long long>(lanes) * feat;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int z = static_cast<int>(e / feat);
    const int f = static_cast<int>(e - static_cast<long long>(z) * feat);
    const int p = ptr[z];
    if (mask[z] != 0 && p >= 0 && p < depth) {
      stack[(static_cast<long long>(p) * lanes + z) * feat + f] = val[e];
    }
  }
}

template <typename T>
__global__ void peek_kernel(T* __restrict__ out, const T* __restrict__ stack,
                            const int32_t* __restrict__ ptr, int depth, int lanes, int feat) {
  const long long n = static_cast<long long>(lanes) * feat;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int z = static_cast<int>(e / feat);
    const int f = static_cast<int>(e - static_cast<long long>(z) * feat);
    int p = ptr[z];
    p = p < 0 ? 0 : (p > depth - 1 ? depth - 1 : p);
    out[e] = stack[(static_cast<long long>(p) * lanes + z) * feat + f];
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65535 * 32 ? blocks : 65535 * 32);
}

template <typename T>
int launch_push(void* stack, const void* ptr, const void* mask, const void* val, int depth,
                int lanes, int feat, cudaStream_t stream) {
  const long long n = static_cast<long long>(lanes) * feat;
  if (n > 0) {
    push_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<T*>(stack), static_cast<const int32_t*>(ptr),
        static_cast<const uint8_t*>(mask), static_cast<const T*>(val), depth, lanes, feat);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_peek(void* out, const void* stack, const void* ptr, int depth, int lanes, int feat,
                cudaStream_t stream) {
  const long long n = static_cast<long long>(lanes) * feat;
  if (n > 0) {
    peek_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<T*>(out), static_cast<const T*>(stack), static_cast<const int32_t*>(ptr),
        depth, lanes, feat);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stack_ops_push(void* stack, const void* ptr, const void* mask, const void* val,
                              int depth, int lanes, int feat, int elem_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1: return launch_push<uint8_t>(stack, ptr, mask, val, depth, lanes, feat, s);
    case 2: return launch_push<uint16_t>(stack, ptr, mask, val, depth, lanes, feat, s);
    case 4: return launch_push<uint32_t>(stack, ptr, mask, val, depth, lanes, feat, s);
    case 8: return launch_push<uint64_t>(stack, ptr, mask, val, depth, lanes, feat, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int stack_ops_peek(void* out, const void* stack, const void* ptr, int depth, int lanes,
                              int feat, int elem_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1: return launch_peek<uint8_t>(out, stack, ptr, depth, lanes, feat, s);
    case 2: return launch_peek<uint16_t>(out, stack, ptr, depth, lanes, feat, s);
    case 4: return launch_peek<uint32_t>(out, stack, ptr, depth, lanes, feat, s);
    case 8: return launch_peek<uint64_t>(out, stack, ptr, depth, lanes, feat, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
