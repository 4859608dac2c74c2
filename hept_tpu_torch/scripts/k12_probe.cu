// Design probe for K12 (csrc/sort.cu), built and driven by k12_probe.py: the
// cluster route's two kernels apart, and the designs they were chosen over:
//  - first_cut_sort_kernel: runs of 16 .. S / 2 merged in shared memory
//    (the shipped kernel sorts each warp's 512 pairs by shuffles first), and
//    the cluster's merges by per-thread merge paths that read the other
//    CTAs' pairs one at a time through distributed shared memory (the
//    shipped kernel copies each round's windows in and merges locally);
//  - dsmem_move_kernel<P>: each payload moved by a cluster per (row, P
//    payloads), each CTA reading its sources coalesced and storing each
//    value at its slot in the owning CTA's shared memory;
//  - l2_gather_kernel: every payload gathered through L2 by the sorted
//    positions, the loads of 4 payloads x 4 slots issued before the stores;
//  - probe_overlap: the rows in two groups on two streams.
#include <cuda_runtime.h>
#include <stdint.h>

// the sort kernel's phase marks: SM clock of thread 0 of each CTA
constexpr int kMarks = 17, kMaxMarkedCtas = 4096;
__device__ long long g_marks[kMaxMarkedCtas * kMarks];
#define K12_MARK(phase)                                                      \
  do {                                                                        \
    if (threadIdx.x == 0 && blockIdx.x < kMaxMarkedCtas)                      \
      g_marks[blockIdx.x * kMarks + (phase)] = clock64();                     \
  } while (0)

#include "../csrc/sort.cu"

namespace {

constexpr int kProbeThreads = 512;

// one pair of the cluster's row at a time, through distributed shared memory
struct RemotePairs {
  Pairs own;
  int lg;
  __device__ __forceinline__ uint64_t k(int i) const { return row_key(own, lg, i); }
  __device__ __forceinline__ uint32_t p(int i) const { return row_pos(own, lg, i); }
};

__device__ __forceinline__ void remote_merge(const RemotePairs& s, int run, int o,
                                             uint64_t (&k)[kItems], uint32_t (&p)[kItems]) {
  const int a0 = o & ~(2 * run - 1), b0 = a0 + run, d = o - a0;
  int lo = d > run ? d - run : 0, hi = d < run ? d : run;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    const uint64_t ka = s.k(a0 + m), kb = s.k(b0 + d - 1 - m);
    if (ka < kb || (ka == kb && s.p(a0 + m) < s.p(b0 + d - 1 - m)))
      lo = m + 1;
    else
      hi = m;
  }
  int a = lo, b = d - lo;
  uint64_t ka = 0, kb = 0;
  uint32_t pa = 0, pb = 0;
  if (a < run) ka = s.k(a0 + a), pa = s.p(a0 + a);
  if (b < run) kb = s.k(b0 + b), pb = s.p(b0 + b);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool take_a = b >= run || (a < run && (ka < kb || (ka == kb && pa < pb)));
    k[j] = take_a ? ka : kb;
    p[j] = take_a ? pa : pb;
    if (j + 1 < kItems) {
      if (take_a) {
        if (++a < run) ka = s.k(a0 + a), pa = s.p(a0 + a);
      } else {
        if (++b < run) kb = s.k(b0 + b), pb = s.p(b0 + b);
      }
    }
  }
}

__global__ void __launch_bounds__(kSortThreads, 1)
    first_cut_sort_kernel(const float* __restrict__ keys, const int* __restrict__ tie, int n,
                          uint16_t* __restrict__ perm) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int t = threadIdx.x, s_len = blockDim.x * kItems;
  const int lg = __ffs(s_len) - 1;
  const Pairs own(smem, s_len);
  const size_t row = blockIdx.x / nc;
  const int base = c * s_len, o = t * kItems;
  for (int i = t; i < s_len; i += blockDim.x) {
    const int g = base + i;
    own.key[kx(i)] = g < n ? order_key(keys[row * n + g], tie[row * n + g]) : ~0ull;
    own.pos[px(i)] = (uint32_t)g;
  }
  __syncthreads();
  uint64_t k[kItems];
  uint32_t p[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) k[j] = own.k(o + j), p[j] = own.p(o + j);
  sort_registers(k, p);
  store_pairs(own, o, k, p);
  __syncthreads();
  for (int run = kItems; run < s_len; run <<= 1) {
    const int a0 = o & ~(2 * run - 1);
    merge_path(own, a0, run, a0 + run, run, o - a0, k, p);
    __syncthreads();
    store_pairs(own, o, k, p);
    __syncthreads();
  }
  const RemotePairs remote{own, lg};
  for (int run = s_len; run < nc * s_len; run <<= 1) {
    cluster.sync();
    remote_merge(remote, run, base + o, k, p);
    cluster.sync();
    store_pairs(own, o, k, p);
  }
  __syncthreads();
  for (int i = t; i < s_len && base + i < n; i += blockDim.x)
    perm[row * n + base + i] = (uint16_t)own.p(i);
}

template <int P>
__global__ void __launch_bounds__(kProbeThreads)
    dsmem_move_kernel(const int* __restrict__ rank, Payloads pay, int ops, int n, int lg) {
  extern __shared__ __align__(16) uint32_t slots[];  // P x S
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int s_len = 1 << lg, groups = (ops + P - 1) / P;
  const int id = blockIdx.x / nc;
  const size_t row = id / groups;
  const int op0 = (id % groups) * P;
  const int lo = c * s_len, hi = min(n, lo + s_len);
  const int* rrow = rank + row * n;
  for (int j0 = lo + threadIdx.x; j0 < hi; j0 += 4 * blockDim.x) {
    int r[4];
    uint32_t v[4][P];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * blockDim.x;
      r[u] = j < hi ? rrow[j] : -1;
#pragma unroll
      for (int q = 0; q < P; ++q)
        v[u][q] = j < hi && op0 + q < ops ? __ldg(pay.in[op0 + q] + row * n + j) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r[u] < 0) continue;
      uint32_t* dst = cluster.map_shared_rank(slots, r[u] >> lg) + (r[u] & (s_len - 1));
#pragma unroll
      for (int q = 0; q < P; ++q)
        if (op0 + q < ops) dst[q * s_len] = v[u][q];
    }
  }
  cluster.sync();
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (op0 + q >= ops) break;
    uint32_t* out = pay.out[op0 + q] + row * n;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) out[i] = slots[q * s_len + i - lo];
  }
}

__global__ void invert_kernel(const uint16_t* __restrict__ perm, int* __restrict__ rank, int n) {
  const size_t row = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) rank[row * n + perm[row * n + i]] = i;
}

__global__ void __launch_bounds__(256)
    l2_gather_kernel(const uint16_t* __restrict__ perm, Payloads pay, int ops, int n) {
  const size_t row = blockIdx.y;
  const int i0 = blockIdx.x * blockDim.x * 4 + threadIdx.x;
  int src[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + u * blockDim.x;
    src[u] = i < n ? perm[row * n + i] : -1;
  }
  for (int op0 = 0; op0 < ops; op0 += 4) {
    uint32_t v[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[q][u] = op0 + q < ops && src[u] >= 0 ? __ldg(pay.in[op0 + q] + row * n + src[u]) : 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (op0 + q < ops && src[u] >= 0) pay.out[op0 + q][row * n + i0 + u * blockDim.x] = v[q][u];
  }
}

}  // namespace

extern "C" int probe_sort(const float* keys, const int* tie, int rows, int n, uint16_t* perm,
                          int first_cut, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!first_cut) return (int)launch_cluster_sort(keys, tie, rows, n, perm, s);
  const ClusterShape sh = cluster_shape(n);
  return (int)launch_cluster(first_cut_sort_kernel, sh.c * rows, sh.c, sh.s / kItems,
                             pairs_bytes(sh.s), s, keys, tie, n, perm);
}

extern "C" int probe_gather(const uint16_t* perm, const void* const* ins, void* const* outs,
                            int ops, int rows, int n, int l2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Payloads pay = payloads(ins, outs, ops);
  if (!l2) return (int)launch_staged_gather(perm, pay, ops, rows, n, s);
  l2_gather_kernel<<<dim3((n + 1023) / 1024, rows), 256, 0, s>>>(perm, pay, ops, n);
  return (int)cudaGetLastError();
}

extern "C" int probe_invert(const uint16_t* perm, int* rank, int rows, int n, void* stream) {
  invert_kernel<<<dim3((n + 255) / 256, rows), 256, 0, (cudaStream_t)stream>>>(perm, rank, n);
  return (int)cudaGetLastError();
}

// dsmem_move_kernel<pays>, move_c CTAs a row
extern "C" int probe_move(const int* rank, const void* const* ins, void* const* outs, int ops,
                          int rows, int n, int move_c, int pays, void* stream) {
  const ClusterShape sh = cluster_shape(n);
  const int s_len = sh.c * sh.s / move_c, lg = __builtin_ctz((unsigned)s_len);
  const int grid = move_c * rows * ((ops + pays - 1) / pays);
  const size_t smem = (size_t)pays * s_len * sizeof(uint32_t);
  const Payloads pay = payloads(ins, outs, ops);
  cudaStream_t s = (cudaStream_t)stream;
  if (pays == 1)
    return (int)launch_cluster(dsmem_move_kernel<1>, grid, move_c, kProbeThreads, smem, s, rank,
                               pay, ops, n, lg);
  if (pays == 2)
    return (int)launch_cluster(dsmem_move_kernel<2>, grid, move_c, kProbeThreads, smem, s, rank,
                               pay, ops, n, lg);
  return (int)cudaErrorInvalidValue;
}

// the marks of the last sort launch (rows * CTAs a row of kMarks each)
extern "C" int probe_marks(long long* host, int count) {
  return (int)cudaMemcpyFromSymbol(host, g_marks, sizeof(long long) * count);
}

// the cluster route with its rows in two groups on two streams: the first
// `split` rows' sort then gather on `stream`, the rest's on a second stream
// forked from it and joined back, so the first group's gather can fill the
// SMs the second group's sort leaves free
extern "C" int probe_overlap(const float* keys, const void* const* ins, void* const* outs,
                             int ops, int rows, int n, int split, uint16_t* perm, void* stream) {
  static cudaStream_t side = nullptr;
  static cudaEvent_t fork = nullptr, join = nullptr;
  cudaError_t err = cudaSuccess;
  if (side == nullptr) {
    if ((err = cudaStreamCreateWithFlags(&side, cudaStreamNonBlocking)) != cudaSuccess ||
        (err = cudaEventCreateWithFlags(&fork, cudaEventDisableTiming)) != cudaSuccess ||
        (err = cudaEventCreateWithFlags(&join, cudaEventDisableTiming)) != cudaSuccess)
      return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int* tie = (const int*)ins[ops - 1];
  Payloads first = payloads(ins, outs, ops), second = first;
  for (int op = 0; op < ops; ++op) {
    second.in[op] += (size_t)split * n;
    second.out[op] += (size_t)split * n;
  }
  if ((err = cudaEventRecord(fork, s)) != cudaSuccess) return (int)err;
  if ((err = cudaStreamWaitEvent(side, fork, 0)) != cudaSuccess) return (int)err;
  if ((err = launch_cluster_sort(keys, tie, split, n, perm, s)) != cudaSuccess) return (int)err;
  if ((err = launch_cluster_sort(keys + (size_t)split * n, tie + (size_t)split * n, rows - split,
                                 n, perm + (size_t)split * n, side)) != cudaSuccess)
    return (int)err;
  if ((err = launch_staged_gather(perm, first, ops, split, n, s)) != cudaSuccess) return (int)err;
  if ((err = launch_staged_gather(perm + (size_t)split * n, second, ops, rows - split, n, side)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaEventRecord(join, side)) != cudaSuccess) return (int)err;
  return (int)cudaStreamWaitEvent(s, join, 0);
}
