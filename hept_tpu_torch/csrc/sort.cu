// Per-row multi-operand sort (K12): each row of f32 keys sorted ascending by
// (key, tie-break) lexicographically, carrying up to kMaxOps 32-bit payloads.
//
// Replaces the TPU's bitonic sort kernel
//   K12 hept_tpu/ops/sort_pallas.py:_kernel (:58) via _get_sorter (pallas_call
//       at :158), entry bitonic_sort_rows (:179)
// which ran the whole bitonic network of one row (padded to a power of two)
// in VMEM, carrying every payload operand through each of its ~136
// compare-exchange substages. The tie-break is the last payload, the row
// position iota; pads (keys +BIG, positions past n) sort strictly last.
//
// What this kernel does instead. The payloads ride along only as a
// permutation: the network sorts (key, tie-break, position) triples, and one
// gather at the end moves every payload by the sorted positions. Positions
// are unique, so the order is total and the output equals that of carrying
// all payloads through the network, or of any stable lexsort. A row of
// 60000 keys pads to 65536, and its triples take 768 KB, more than a CTA's
// shared memory (227 KB), so the network is split as usual on a GPU:
//   1. tile_sort_kernel: each CTA sorts kTile (4096) triples in shared
//      memory, in the direction of the global network (stages k <= kTile);
//   2. per stage k > kTile: one global_step_kernel launch per stride j >=
//      kTile (each thread one compare-exchange in device memory), then
//      merge_kernel for the strides below kTile in shared memory;
//   3. payload_gather_kernel: out[op][row, i] = in[op][row, pos[row, i]],
//      i < n.
// Pads get key +inf, tie-break INT_MAX and positions n.., so they follow
// every real element (a real +inf key with tie-break INT_MAX still has the
// smaller position). NaN keys have no order, as in the TPU kernel.
//
// What bounds it on the H100: the bytes, each key and payload read once and
// each payload written once, rows * n * 4 * (1 + 2 * ops) bytes (214 MB for
// 24 rows of 60000 with 16 operands: 0.064 ms at 3.35 TB/s). This simple
// version moves the 12-byte triples through device memory on every global
// stride (10 passes at 65536) and reads the payloads with a random gather,
// far above that bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kTile = 4096;       // triples a CTA sorts in shared memory
constexpr int kStepThreads = 256;
constexpr int kMaxOps = 32;

struct Payloads {
  const uint32_t* in[kMaxOps];
  uint32_t* out[kMaxOps];
};

// one row's triples in device memory: key bits, tie-break, position
struct Triples {
  float* key;
  int* tie;
  int* pos;
};

// true if triple a goes after triple b
__device__ __forceinline__ bool after(float ka, int ta, int pa, float kb, int tb, int pb) {
  if (ka != kb) return ka > kb;
  if (ta != tb) return ta > tb;
  return pa > pb;
}

// compare-exchange of slots i < l: ascending unless desc
__device__ __forceinline__ void cmp_swap(float* k, int* t, int* p, int i, int l, bool desc) {
  const float ki = k[i], kl = k[l];
  const int ti = t[i], tl = t[l], pi = p[i], pl = p[l];
  if (after(ki, ti, pi, kl, tl, pl) != desc) {
    k[i] = kl;
    k[l] = ki;
    t[i] = tl;
    t[l] = ti;
    p[i] = pl;
    p[l] = pi;
  }
}

// the strides j = j0, j0/2, .., 1 of stage k on a shared tile starting at
// global slot base; thread t handles pair (i, i + j), i the t-th slot with
// bit j clear
__device__ __forceinline__ void shared_strides(float* k, int* t, int* p, int tile, int base,
                                               int stage, int j0) {
  for (int j = j0; j > 0; j >>= 1) {
    for (int x = threadIdx.x; x < tile / 2; x += blockDim.x) {
      const int i = 2 * x - (x & (j - 1));
      cmp_swap(k, t, p, i, i + j, ((base + i) & stage) != 0);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void to_shared(Triples g, size_t off, int tile, float* k, int* t,
                                          int* p) {
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    k[i] = g.key[off + i];
    t[i] = g.tie[off + i];
    p[i] = g.pos[off + i];
  }
  __syncthreads();
}

__device__ __forceinline__ void from_shared(Triples g, size_t off, int tile, const float* k,
                                            const int* t, const int* p) {
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    g.key[off + i] = k[i];
    g.tie[off + i] = t[i];
    g.pos[off + i] = p[i];
  }
}

// stages 2 .. tile of the network, one tile per CTA, from the inputs
__global__ void tile_sort_kernel(const float* __restrict__ keys, const int* __restrict__ tie,
                                 int n, int n_pad, int tile, Triples g) {
  extern __shared__ int smem[];
  float* k = reinterpret_cast<float*>(smem);
  int* t = smem + tile;
  int* p = smem + 2 * tile;
  const size_t row = blockIdx.y;
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int s = base + i;
    const bool real = s < n;
    k[i] = real ? keys[row * n + s] : __int_as_float(0x7f800000);  // +inf
    t[i] = real ? tie[row * n + s] : INT_MAX;
    p[i] = s;
  }
  __syncthreads();
  for (int stage = 2; stage <= tile; stage <<= 1) shared_strides(k, t, p, tile, base, stage,
                                                                 stage >> 1);
  from_shared(g, row * n_pad + base, tile, k, t, p);
}

// one stride j >= tile of stage k, in device memory
__global__ void global_step_kernel(Triples g, int n_pad, int j, int stage) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n_pad / 2) return;
  const size_t off = (size_t)blockIdx.y * n_pad;
  const int i = 2 * x - (x & (j - 1));
  cmp_swap(g.key + off, g.tie + off, g.pos + off, i, i + j, (i & stage) != 0);
}

// strides tile/2 .. 1 of stage k > tile, one tile per CTA
__global__ void merge_kernel(Triples g, int n_pad, int tile, int stage) {
  extern __shared__ int smem[];
  float* k = reinterpret_cast<float*>(smem);
  int* t = smem + tile;
  int* p = smem + 2 * tile;
  const size_t off = (size_t)blockIdx.y * n_pad + (size_t)blockIdx.x * tile;
  to_shared(g, off, tile, k, t, p);
  shared_strides(k, t, p, tile, blockIdx.x * tile, stage, tile >> 1);
  from_shared(g, off, tile, k, t, p);
}

__global__ void payload_gather_kernel(const int* __restrict__ pos, Payloads pay, int ops,
                                      int n, int n_pad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t row = blockIdx.y;
  const size_t src = row * n + pos[row * n_pad + i];  // pads sorted past n
  const size_t dst = row * n + i;
  for (int op = 0; op < ops; ++op) pay.out[op][dst] = __ldg(pay.in[op] + src);
}

}  // namespace

// Sort rows x n keys; ins / outs: host arrays of `ops` device pointers to
// (rows, n) 32-bit payloads, ins[ops - 1] the int32 tie-break; scratch: 3 *
// rows * n_pad 4-byte words, n_pad a power of two >= max(n, 2). Returns the
// first CUDA error of the launches.
extern "C" int hept_bitonic_sort_rows(const float* keys, const void* const* ins,
                                      void* const* outs, int ops, int rows, int n, int n_pad,
                                      void* scratch, void* stream) {
  if (rows == 0 || n == 0) return 0;
  if (ops < 1 || ops > kMaxOps || rows > 65535 || n_pad < 2 || n_pad < n ||
      (n_pad & (n_pad - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Payloads pay;
  for (int op = 0; op < ops; ++op) {
    pay.in[op] = (const uint32_t*)ins[op];
    pay.out[op] = (uint32_t*)outs[op];
  }
  const size_t words = (size_t)rows * n_pad;
  Triples g{(float*)scratch, (int*)scratch + words, (int*)scratch + 2 * words};
  const int tile = n_pad < kTile ? n_pad : kTile;
  const int threads = tile / 2 < 1024 ? tile / 2 : 1024;
  const size_t smem = (size_t)tile * 3 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(tile_sort_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 tiles(n_pad / tile, rows);
  tile_sort_kernel<<<tiles, threads, smem, s>>>(keys, (const int*)ins[ops - 1], n, n_pad, tile,
                                                g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 steps((n_pad / 2 + kStepThreads - 1) / kStepThreads, rows);
  for (int stage = 2 * tile; stage <= n_pad; stage <<= 1) {
    for (int j = stage >> 1; j >= tile; j >>= 1) {
      global_step_kernel<<<steps, kStepThreads, 0, s>>>(g, n_pad, j, stage);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    merge_kernel<<<tiles, threads, smem, s>>>(g, n_pad, tile, stage);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const dim3 points((n + kStepThreads - 1) / kStepThreads, rows);
  payload_gather_kernel<<<points, kStepThreads, 0, s>>>(g.pos, pay, ops, n, n_pad);
  return (int)cudaGetLastError();
}

extern "C" const char* hept_sort_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
