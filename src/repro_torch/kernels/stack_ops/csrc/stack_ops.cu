// Batched per-lane stack traffic of the program-counter VM (paper Alg. 2),
// hand-written for Hopper (sm_90a) as two grouped, fused kernels with a
// plain C interface for ctypes.
//
// stack_ops_push replaces the Pallas TPU kernel masked_push
// (src/repro/kernels/stack_ops/kernel.py, _push_kernel) and stack_ops_pop
// replaces masked_peek (same file, _peek_kernel).  One launch serves a whole
// run of the VM's pushes (or pops) in a block, up to kMaxEntries stacks, and
// fuses the VM's arithmetic around each stack access:
//
//   push entry, for lane z with mask m = mask[z] and p = ptr[z]:
//     stack[p, z] = top[z]               where m and 0 <= p < D (in place)
//     new_top[z]  = m ? src[z] : top[z]
//     new_ptr[z]  = p + m
//     overflow[z] = 1                    where m and p >= max_depth
//   pop entry:
//     new_ptr[z]  = p - m
//     new_top[z]  = m ? stack[clamp(p - m, 0, D - 1), z] : top[z]
//
// The TPU functions are groups of one without the extras: a zero address
// skips a part (no new_ptr, no new_top, no src, no overflow), and a pop
// without a mask is masked_peek: every lane reads stack[clamp(p, 0, D-1), z]
// and no pointer moves.  A masked-off lane reads no stack row.
//
// Layout: each entry's stack is [D, Z, row bytes] and its pointers int32
// [Z], contiguous; lane z's top row starts at top + z * top_stride and its
// src row at src + z * src_stride (a stride of 0 is one row broadcast to
// every lane, as the VM's constants are); new_top is a dense [Z, row].  The
// kernels copy bits and never interpret them, so bool, bf16, float32,
// int32 and the int32 words of the PRNG keys are all rows of bytes.
//
// Bound: memory bytes; there is no arithmetic, so the tensor cores and TMA
// buy nothing for rows of at most a few hundred bytes, and on this card the
// only gains are fewer launches and fewer bytes.  Counting each byte read
// once and written once, a push entry moves Z*row of old top read and Z*row
// of new top written, W*row of src read and W*row of stack written (W: the
// lanes with m and 0 <= p < D), 9*Z of pointers in and out and flags; a pop
// entry Z*row of new top written and, split by the mask, W*row of stack and
// (Z-W)*row of old top read, plus 8*Z of pointers; the group reads its mask
// (Z bytes) once.  NUTS's widest call block (12 variables and the pc, five
// of them float32 rows of 400 bytes) moves about 8 MB at 1024 lanes, a
// 2.4 us bound at 3.35 TB/s; before this design the same work took 13
// launches of ~2 us each plus ~70 PyTorch launches of pointer, flag and
// select arithmetic.
//
// Design: the table of entries travels by value as a kernel parameter (no
// host-to-device copy).  The grid is (lane tile, entry): a block stages its
// tile's pointers and mask in shared memory once, writing new_ptr and the
// overflow flags there, then copies rows with the widest access (16, 8, 4,
// 2 or 1 bytes) that the row size, the base addresses and the strides
// allow: NUTS's 400-byte float32 rows go as 25 16-byte accesses, its keys
// as one 8-byte access.  Each thread owns one chunk column of a few lanes
// (one divide a thread, none an element) and issues the loads of kUnroll
// lanes before their stores.  The tile shrinks for small groups so that a
// launch still spreads over the card's 132 SMs.  Only 1 is ever stored into
// overflow, so entries racing on it agree.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() so that a refused
// launch is reported to the caller.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxEntries = 16;
constexpr int kThreads = 256;
constexpr int kTileLanes = 64;   // lanes a block handles, at most
constexpr int kMinTileLanes = 8;
constexpr int kTargetBlocks = 264;  // two blocks for each of the H100's 132 SMs
constexpr int kUnroll = 4;

// One stack of a group: 10 int64 words, the layout kernel.py packs.
struct Entry {
  long long stack;       // [D, Z, row]: written (push) or read (pop)
  long long ptr;         // int32 [Z]
  long long new_ptr;     // int32 [Z] out; 0: not written
  long long top;         // lane z's row at top + z * top_stride
  long long new_top;     // dense [Z, row] out; 0: not written
  long long src;         // push: lane z's row at src + z * src_stride; 0: none
  long long depth;       // D
  long long row_bytes;
  long long top_stride;  // bytes between lanes' rows (0: broadcast)
  long long src_stride;
};

struct Table {
  Entry e[kMaxEntries];
};
static_assert(sizeof(Entry) == 80, "kernel.py packs 10 int64 words an entry");
static_assert(sizeof(Table) + 64 <= 4096, "the table is a kernel parameter");

// The widest access that every row start of the entry is aligned to.
__device__ __forceinline__ int access_width(const Entry& e) {
  const unsigned long long bits = static_cast<unsigned long long>(
      e.row_bytes | e.stack | e.top | e.top_stride | e.new_top | e.src | e.src_stride);
  if ((bits & 15) == 0) return 16;
  if ((bits & 7) == 0) return 8;
  if ((bits & 3) == 0) return 4;
  if ((bits & 1) == 0) return 2;
  return 1;
}

// Thread -> (first lane, lane step, chunk, chunk step) over a tile whose rows
// hold `chunks` accesses.  Rows of more than kThreads chunks: one lane at a
// time, the threads striding over its chunks.
struct Walk {
  int lane, lane_step, chunk, chunk_step;
};

__device__ __forceinline__ Walk walk(int chunks) {
  Walk w;
  if (chunks <= kThreads) {
    w.lane_step = kThreads / chunks;
    w.lane = threadIdx.x / chunks;
    w.chunk = threadIdx.x - w.lane * chunks;
    w.chunk_step = chunks;
  } else {
    w.lane_step = 1;
    w.lane = 0;
    w.chunk = threadIdx.x;
    w.chunk_step = kThreads;
  }
  return w;
}

template <typename T>
__device__ __forceinline__ void push_rows(const Entry& e, const int* s_ptr, const uint8_t* s_mask,
                                          int lane0, int nl, int lanes) {
  const int chunks = static_cast<int>(e.row_bytes / static_cast<long long>(sizeof(T)));
  if (chunks == 0) return;
  const Walk w = walk(chunks);
  if (w.lane >= w.lane_step) return;
  char* stack = reinterpret_cast<char*>(e.stack);
  const char* top = reinterpret_cast<const char*>(e.top);
  char* new_top = reinterpret_cast<char*>(e.new_top);
  const char* src = reinterpret_cast<const char*>(e.src);
  for (int c = w.chunk; c < chunks; c += w.chunk_step) {
    const long long off = static_cast<long long>(c) * sizeof(T);
    for (int l0 = w.lane; l0 < nl; l0 += kUnroll * w.lane_step) {
      T v[kUnroll], s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int l = l0 + u * w.lane_step;
        if (l >= nl) continue;
        const long long z = lane0 + l;
        const int p = s_ptr[l];
        const bool m = s_mask[l] != 0;
        const bool store = m && p >= 0 && p < e.depth;
        const bool take_src = m && src != nullptr;
        if (store || (new_top != nullptr && !take_src))
          v[u] = *reinterpret_cast<const T*>(top + z * e.top_stride + off);
        if (new_top != nullptr && take_src)
          s[u] = *reinterpret_cast<const T*>(src + z * e.src_stride + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int l = l0 + u * w.lane_step;
        if (l >= nl) continue;
        const long long z = lane0 + l;
        const int p = s_ptr[l];
        const bool m = s_mask[l] != 0;
        if (m && p >= 0 && p < e.depth)
          *reinterpret_cast<T*>(stack + (static_cast<long long>(p) * lanes + z) * e.row_bytes +
                                off) = v[u];
        if (new_top != nullptr)
          *reinterpret_cast<T*>(new_top + z * e.row_bytes + off) =
              (m && src != nullptr) ? s[u] : v[u];
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void pop_rows(const Entry& e, const int* s_row, const uint8_t* s_mask,
                                         int lane0, int nl, int lanes) {
  const int chunks = static_cast<int>(e.row_bytes / static_cast<long long>(sizeof(T)));
  if (chunks == 0) return;
  const Walk w = walk(chunks);
  if (w.lane >= w.lane_step) return;
  const char* stack = reinterpret_cast<const char*>(e.stack);
  const char* top = reinterpret_cast<const char*>(e.top);
  char* new_top = reinterpret_cast<char*>(e.new_top);
  for (int c = w.chunk; c < chunks; c += w.chunk_step) {
    const long long off = static_cast<long long>(c) * sizeof(T);
    for (int l0 = w.lane; l0 < nl; l0 += kUnroll * w.lane_step) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int l = l0 + u * w.lane_step;
        if (l >= nl) continue;
        const long long z = lane0 + l;
        v[u] = s_mask[l] != 0
                   ? *reinterpret_cast<const T*>(
                         stack + (static_cast<long long>(s_row[l]) * lanes + z) * e.row_bytes + off)
                   : *reinterpret_cast<const T*>(top + z * e.top_stride + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int l = l0 + u * w.lane_step;
        if (l >= nl) continue;
        const long long z = lane0 + l;
        *reinterpret_cast<T*>(new_top + z * e.row_bytes + off) = v[u];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    push_kernel(const Table table, const uint8_t* __restrict__ mask,
                uint8_t* __restrict__ overflow, int max_depth, int lanes, int tile) {
  const Entry e = table.e[blockIdx.y];
  const int lane0 = blockIdx.x * tile;
  const int nl = min(tile, lanes - lane0);
  __shared__ int s_ptr[kTileLanes];
  __shared__ uint8_t s_mask[kTileLanes];
  if (threadIdx.x < nl) {
    const int z = lane0 + threadIdx.x;
    const int p = reinterpret_cast<const int32_t*>(e.ptr)[z];
    const uint8_t m = mask[z] != 0;
    s_ptr[threadIdx.x] = p;
    s_mask[threadIdx.x] = m;
    if (e.new_ptr != 0) reinterpret_cast<int32_t*>(e.new_ptr)[z] = p + m;
    if (overflow != nullptr && m && p >= max_depth) overflow[z] = 1;
  }
  __syncthreads();
  switch (access_width(e)) {
    case 16: push_rows<uint4>(e, s_ptr, s_mask, lane0, nl, lanes); break;
    case 8: push_rows<uint2>(e, s_ptr, s_mask, lane0, nl, lanes); break;
    case 4: push_rows<uint32_t>(e, s_ptr, s_mask, lane0, nl, lanes); break;
    case 2: push_rows<uint16_t>(e, s_ptr, s_mask, lane0, nl, lanes); break;
    default: push_rows<uint8_t>(e, s_ptr, s_mask, lane0, nl, lanes); break;
  }
}

__global__ void __launch_bounds__(kThreads)
    pop_kernel(const Table table, const uint8_t* __restrict__ mask, int lanes, int tile) {
  const Entry e = table.e[blockIdx.y];
  const int lane0 = blockIdx.x * tile;
  const int nl = min(tile, lanes - lane0);
  __shared__ int s_row[kTileLanes];
  __shared__ uint8_t s_mask[kTileLanes];
  if (threadIdx.x < nl) {
    const int z = lane0 + threadIdx.x;
    const int p = reinterpret_cast<const int32_t*>(e.ptr)[z];
    // No mask: masked_peek, every lane reads at its pointer.
    const int m = mask == nullptr ? 1 : (mask[z] != 0);
    const int q = mask == nullptr ? p : p - m;
    if (e.new_ptr != 0) reinterpret_cast<int32_t*>(e.new_ptr)[z] = q;
    const int d = static_cast<int>(e.depth);
    s_row[threadIdx.x] = q < 0 ? 0 : (q > d - 1 ? d - 1 : q);
    s_mask[threadIdx.x] = static_cast<uint8_t>(m);
  }
  __syncthreads();
  switch (access_width(e)) {
    case 16: pop_rows<uint4>(e, s_row, s_mask, lane0, nl, lanes); break;
    case 8: pop_rows<uint2>(e, s_row, s_mask, lane0, nl, lanes); break;
    case 4: pop_rows<uint32_t>(e, s_row, s_mask, lane0, nl, lanes); break;
    case 2: pop_rows<uint16_t>(e, s_row, s_mask, lane0, nl, lanes); break;
    default: pop_rows<uint8_t>(e, s_row, s_mask, lane0, nl, lanes); break;
  }
}

// Lanes a block takes: kTileLanes, halved while the grid would leave SMs idle.
int tile_for(int lanes, int n) {
  int tile = kTileLanes;
  while (tile > kMinTileLanes && static_cast<long long>((lanes + tile - 1) / tile) * n < kTargetBlocks)
    tile /= 2;
  return tile;
}

// Copies n entries into *t; false where n or an entry cannot be launched: a
// zero address is allowed only for a part that is skipped or holds no bytes.
// A push reads its top; a pop writes its new top and, with a mask, reads
// its top.
bool load_table(Table* t, const long long* words, int n, bool pop, bool masked) {
  if (n < 1 || n > kMaxEntries) return false;
  std::memset(t, 0, sizeof(*t));
  std::memcpy(t->e, words, sizeof(Entry) * n);
  for (int i = 0; i < n; ++i) {
    const Entry& e = t->e[i];
    if (e.ptr == 0 || e.depth < 1 || e.row_bytes < 0) return false;
    if (e.row_bytes == 0) continue;
    if (e.stack == 0) return false;
    if (pop ? (e.new_top == 0 || (masked && e.top == 0)) : e.top == 0) return false;
  }
  return true;
}

}  // namespace

// `table` holds n entries of 10 int64 words (struct Entry), 1 <= n <= 16.
extern "C" int stack_ops_push(const long long* table, int n, const void* mask, void* overflow,
                              int max_depth, int lanes, void* stream) {
  if (lanes < 0 || mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return static_cast<int>(cudaGetLastError());
  Table t;
  if (!load_table(&t, table, n, false, true)) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = tile_for(lanes, n);
  const dim3 grid((lanes + tile - 1) / tile, n);
  push_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(overflow), max_depth, lanes,
      tile);
  return static_cast<int>(cudaGetLastError());
}

// `mask` may be null: every lane peeks at its pointer (masked_peek).
extern "C" int stack_ops_pop(const long long* table, int n, const void* mask, int lanes,
                             void* stream) {
  if (lanes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return static_cast<int>(cudaGetLastError());
  Table t;
  if (!load_table(&t, table, n, true, mask != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = tile_for(lanes, n);
  const dim3 grid((lanes + tile - 1) / tile, n);
  pop_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const uint8_t*>(mask), lanes, tile);
  return static_cast<int>(cudaGetLastError());
}
