// Per-row multi-operand sort (K12): each row of f32 keys sorted ascending by
// (key, tie-break) lexicographically, carrying up to kMaxOps 32-bit payloads.
//
// Replaces the TPU's bitonic sort kernel
//   K12 hept_tpu/ops/sort_pallas.py:_kernel (:58) via _get_sorter (pallas_call
//       at :158), entry bitonic_sort_rows (:179)
// which ran the whole bitonic network of one row (padded to a power of two)
// in VMEM, carrying every payload operand through each of its ~136
// compare-exchange substages. The tie-break is the last payload, the row
// position iota; leftover ties go by position. The order is total on keys
// without NaN, so any correct sort gives the same output bits.
//
// What bounds it on the H100: the bytes, each key and payload read once and
// each payload written once, rows * n * 4 * (1 + 2 * ops) bytes (190 MB for
// 24 rows of 60000 with 16 payloads: 0.057 ms at 3.35 TB/s). The payloads are
// almost all of it, so each is moved once, coalesced both ways; the sort
// itself touches only keys and positions, and keeps them on chip.
//
// Two routes, picked by shape before launch (ops/sort.py:sort_route):
//
// "cluster", n <= kClusterMaxN (65536): two launches.
//   1. cluster_sort_kernel: one row per thread-block cluster of C <= 8 CTAs,
//      each holding S <= 8192 (64-bit key, position) pairs in shared memory.
//      The key is the f32 bits made orderable (-0.0 folded onto +0.0) above
//      the tie-break with its sign bit flipped, so one unsigned compare
//      orders (key, tie-break); the position breaks what is left. Each
//      thread sorts 16 pairs in registers (a bitonic network), each warp
//      its 512 by bitonic merges across lanes (shuffles), the CTA the rest
//      by merge path in shared memory (each thread finds its split by binary
//      search, then merges 16 outputs). The cluster then merges its slices
//      in log2(C) rounds: a warp finds the CTA's split by a 32-way search,
//      the CTA copies its window of each run in through distributed shared
//      memory (coalesced), and merges it locally. No pass goes through device
//      memory. Each CTA writes its slice of the sorted positions (uint16).
//   2. staged_gather_kernel: one CTA per (row, payload) reads the payload's input
//      row into shared memory (227 KB hold 58112 values, all of a row of
//      60000 but a tail read through L1) by 16-byte loads, then writes the
//      output row by 16-byte stores, each value taken from shared memory at
//      its sorted position.
//   Measured against the alternatives by scripts/k12_probe.py: the first
//   cut's cluster merges read the other CTAs' pairs one at a time (twice
//   the time), and moving the payloads through distributed shared memory
//   or gathering them through L2 were slower than the staged gather.
// "bitonic", longer rows: the network of the first port. Triples (key,
//   tie-break, position) are sorted by a 4096-slot shared-memory tile sort,
//   one launch per global stride >= 4096 and a shared merge per stage, then
//   one payload gather by the sorted positions. It moves the triples through
//   device memory on every global stride and gathers at random.
//
// Pads (slots past n) get the largest key and positions >= n, so they follow
// every real pair. NaN keys have no order, as in the TPU kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

// phase marks of the sort kernel, for the design probe (scripts/k12_probe.cu
// defines it before including this file); nothing here
#ifndef K12_MARK
#define K12_MARK(phase)
#endif

namespace {

constexpr int kMaxOps = 32;

struct Payloads {
  const uint32_t* in[kMaxOps];
  uint32_t* out[kMaxOps];
};

// ---------------------------------------------------------------- cluster route

constexpr int kItems = 16;                          // pairs a thread sorts in registers
constexpr int kSortThreads = 512;                   // threads of a full-size slice
constexpr int kSlice = kItems * kSortThreads;       // 8192 pairs a CTA holds at most
constexpr int kMaxCluster = 8;                      // portable cluster size
constexpr int kClusterMaxN = kSlice * kMaxCluster;  // 65536
constexpr int kGatherThreads = 1024;
constexpr int kMaxSmem = 232448;  // shared memory a CTA may have (227 KB)

// (key, tie-break) as one unsigned 64-bit key: the f32 bits with -0.0 folded
// onto +0.0, negatives inverted and positives' sign bit set, above the
// tie-break with its sign bit flipped
__device__ __forceinline__ uint64_t order_key(float key, int tie) {
  uint32_t u = __float_as_uint(key);
  if (u == 0x80000000u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)u << 32) | (uint32_t)(tie ^ INT_MIN);
}

// shared-memory index of pair i: a skew per 128-byte line, so that the 32
// threads of a warp reading kItems consecutive pairs each hit distinct banks
__device__ __forceinline__ int kx(int i) { return i + (i >> 4); }  // 8-byte keys
__device__ __forceinline__ int px(int i) { return i + (i >> 5); }  // 4-byte positions

// bytes of one buffer of s pairs
__host__ __device__ constexpr size_t pairs_bytes(int s) {
  return 8 * (size_t)(s + s / 16) + 4 * (size_t)(s + s / 32);
}

// s pairs in shared memory, at the skewed indices
struct Pairs {
  uint64_t* key;
  uint32_t* pos;
  __device__ __forceinline__ Pairs(unsigned char* base, int s)
      : key(reinterpret_cast<uint64_t*>(base)),
        pos(reinterpret_cast<uint32_t*>(base + 8 * (size_t)(s + s / 16))) {}
  __device__ __forceinline__ uint64_t k(int i) const { return key[kx(i)]; }
  __device__ __forceinline__ uint32_t p(int i) const { return pos[px(i)]; }
  __device__ __forceinline__ bool before(int a, int b) const {
    const uint64_t ka = k(a), kb = k(b);
    return ka < kb || (ka == kb && p(a) < p(b));
  }
};

// ascending compare-exchange of (ka, pa) and (kb, pb)
__device__ __forceinline__ void cas(uint64_t& ka, uint32_t& pa, uint64_t& kb, uint32_t& pb) {
  const bool swap = kb < ka || (kb == ka && pb < pa);
  const uint64_t k = ka;
  const uint32_t p = pa;
  ka = swap ? kb : ka;
  pa = swap ? pb : pa;
  kb = swap ? k : kb;
  pb = swap ? p : pb;
}

// a bitonic network over a thread's kItems pairs, in registers
__device__ __forceinline__ void sort_registers(uint64_t (&k)[kItems], uint32_t (&p)[kItems]) {
#pragma unroll
  for (int size = 2; size <= kItems; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int l = i ^ stride;
        if (l > i) {
          if ((i & size) == 0)
            cas(k[i], p[i], k[l], p[l]);
          else
            cas(k[l], p[l], k[i], p[i]);
        }
      }
}

// outputs d .. d + kItems - 1 of merging the sorted runs src[a0, a0 + na)
// and src[b0, b0 + nb), into k / p
__device__ __forceinline__ void merge_path(const Pairs& s, int a0, int na, int b0, int nb, int d,
                                           uint64_t (&k)[kItems], uint32_t (&p)[kItems]) {
  // how many of the first d outputs come from run A
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (s.before(a0 + m, b0 + d - 1 - m))
      lo = m + 1;
    else
      hi = m;
  }
  int a = lo, b = d - lo;
  uint64_t ka = 0, kb = 0;
  uint32_t pa = 0, pb = 0;
  if (a < na) ka = s.k(a0 + a), pa = s.p(a0 + a);
  if (b < nb) kb = s.k(b0 + b), pb = s.p(b0 + b);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool take_a = b >= nb || (a < na && (ka < kb || (ka == kb && pa < pb)));
    k[j] = take_a ? ka : kb;
    p[j] = take_a ? pa : pb;
    if (j + 1 < kItems) {
      if (take_a) {
        if (++a < na) ka = s.k(a0 + a), pa = s.p(a0 + a);
      } else {
        if (++b < nb) kb = s.k(b0 + b), pb = s.p(b0 + b);
      }
    }
  }
}

// one step of a bitonic merge across lanes: each pair meets its partner in
// lane (lane ^ m), the pair at the same index or (kMirror) at the mirrored
// one, and the lane keeping the smaller of each two keeps it
template <bool kMirror>
__device__ __forceinline__ void lane_step(uint64_t (&k)[kItems], uint32_t (&p)[kItems], int m,
                                          bool keep_small) {
  uint64_t ok[kItems];
  uint32_t op[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    ok[j] = __shfl_xor_sync(0xffffffffu, k[kMirror ? kItems - 1 - j : j], m);
    op[j] = __shfl_xor_sync(0xffffffffu, p[kMirror ? kItems - 1 - j : j], m);
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool other_first = ok[j] < k[j] || (ok[j] == k[j] && op[j] < p[j]);
    if (other_first == keep_small) k[j] = ok[j], p[j] = op[j];
  }
}

// the 32 lanes' kItems pairs (lane l holding pairs 16 l .. 16 l + 15, each
// lane's sorted ascending) sorted as one run of 512: per doubling, a bitonic
// merge whose first step compares each pair with its mirror in the other
// half (so both halves stay ascending), by shuffles for strides >= kItems
// and in registers below
__device__ __forceinline__ void sort_warp(uint64_t (&k)[kItems], uint32_t (&p)[kItems]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int lanes = 2; lanes <= 32; lanes <<= 1) {  // lanes the merged run spans
    lane_step<true>(k, p, lanes - 1, (lane & (lanes >> 1)) == 0);
#pragma unroll
    for (int m = lanes >> 2; m > 0; m >>= 1) lane_step<false>(k, p, m, (lane & m) == 0);
#pragma unroll
    for (int stride = kItems / 2; stride > 0; stride >>= 1)
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if ((j & stride) == 0) cas(k[j], p[j], k[j + stride], p[j + stride]);
  }
}

__device__ __forceinline__ void store_pairs(const Pairs& s, int o, const uint64_t (&k)[kItems],
                                            const uint32_t (&p)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    s.key[kx(o + j)] = k[j];
    s.pos[px(o + j)] = p[j];
  }
}

// pair i of the cluster's row, in slice i >> lg, through distributed shared
// memory
__device__ __forceinline__ uint64_t row_key(const Pairs& own, int lg, int i) {
  return cg::this_cluster().map_shared_rank(own.key, i >> lg)[kx(i & ((1 << lg) - 1))];
}
__device__ __forceinline__ uint32_t row_pos(const Pairs& own, int lg, int i) {
  return cg::this_cluster().map_shared_rank(own.pos, i >> lg)[px(i & ((1 << lg) - 1))];
}

// called by one whole warp: the merge path's split at diagonal d of the
// row's runs [a0, a0 + run) and [b0, b0 + run), by a 32-way search (32
// probes a step, so 3 steps of remote reads for a run of 32768)
__device__ __forceinline__ int warp_split(const Pairs& own, int lg, int a0, int b0, int run,
                                          int d) {
  const int lane = threadIdx.x & 31;
  int lo = d > run ? d - run : 0, hi = d < run ? d : run;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int m = lo + lane * step;
    bool before = false;  // A[m] goes before B[d - 1 - m]: the split is past m
    if (m < hi) {
      const uint64_t ka = row_key(own, lg, a0 + m), kb = row_key(own, lg, b0 + d - 1 - m);
      before = ka < kb ||
               (ka == kb && row_pos(own, lg, a0 + m) < row_pos(own, lg, b0 + d - 1 - m));
    }
    const int ahead = __popc(__ballot_sync(0xffffffffu, before));  // a prefix of the lanes
    if (step == 1) return lo + ahead;
    const int new_hi = lo + ahead * step;
    lo = ahead ? lo + (ahead - 1) * step + 1 : lo;
    hi = new_hi < hi ? new_hi : hi;
  }
  return lo;
}

// perm[row, slot] = the position sorted to that slot (< 65536); one row per cluster of
// C CTAs, each holding S = blockDim.x * kItems pairs (a power of two): its
// slice, then a staging buffer for the cluster's merges
__global__ void __launch_bounds__(kSortThreads, 1)
    cluster_sort_kernel(const float* __restrict__ keys, const int* __restrict__ tie, int n,
                     uint16_t* __restrict__ perm) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int t = threadIdx.x, s_len = blockDim.x * kItems;
  const int lg = __ffs(s_len) - 1;
  const Pairs own(smem, s_len), stage(smem + pairs_bytes(s_len), s_len);
  __shared__ int split[2];
  const size_t row = blockIdx.x / nc;
  const int base = c * s_len, o = t * kItems;
  K12_MARK(0);

  // this slice's pairs, read coalesced (every load issued before the stores)
  uint64_t k[kItems];
  uint32_t p[kItems];
  {
    float kf[kItems];
    int kt[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int g = base + t + j * (int)blockDim.x;
      kf[j] = g < n ? keys[row * n + g] : 0.0f;
      kt[j] = g < n ? tie[row * n + g] : 0;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t + j * blockDim.x;
      own.key[kx(i)] = base + i < n ? order_key(kf[j], kt[j]) : ~0ull;
      own.pos[px(i)] = (uint32_t)(base + i);
    }
  }
  __syncthreads();
  K12_MARK(1);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = own.k(o + j);
    p[j] = own.p(o + j);
  }
  sort_registers(k, p);
  sort_warp(k, p);
  store_pairs(own, o, k, p);
  __syncthreads();
  K12_MARK(2);

  // runs of 32 kItems .. S / 2 merged within the slice
  for (int run = 32 * kItems; run < s_len; run <<= 1) {
    const int a0 = o & ~(2 * run - 1);
    merge_path(own, a0, run, a0 + run, run, o - a0, k, p);
    __syncthreads();
    store_pairs(own, o, k, p);
    __syncthreads();
  }
  K12_MARK(3);
  // slices merged across the cluster: this CTA's S outputs of a round take
  // one window of each run; the windows are copied in (coalesced reads of
  // distributed shared memory) and merged here
  for (int run = s_len; run < nc * s_len; run <<= 1) {
    const int a0 = base & ~(2 * run - 1), b0 = a0 + run, d = base - a0;
    cluster.sync();  // every slice holds the last round's runs
    K12_MARK(4 + 4 * (__ffs(run) - 1 - lg));
    if (t < 64) {
      const int a = warp_split(own, lg, a0, b0, run, d + (t >> 5) * s_len);
      if ((t & 31) == 0) split[t >> 5] = a;
    }
    __syncthreads();
    K12_MARK(5 + 4 * (__ffs(run) - 1 - lg));
    const int a_lo = split[0], na = split[1] - a_lo;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {  // every remote load issued before the stores
      const int i = t + j * blockDim.x;
      const int g = i < na ? a0 + a_lo + i : b0 + d - a_lo + (i - na);
      k[j] = row_key(own, lg, g);
      p[j] = row_pos(own, lg, g);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      stage.key[kx(t + j * blockDim.x)] = k[j];
      stage.pos[px(t + j * blockDim.x)] = p[j];
    }
    cluster.sync();  // every window is copied: the slices may change
    K12_MARK(6 + 4 * (__ffs(run) - 1 - lg));
    merge_path(stage, 0, na, na, s_len - na, o, k, p);
    store_pairs(own, o, k, p);
    K12_MARK(7 + 4 * (__ffs(run) - 1 - lg));
  }
  __syncthreads();
  for (int i = t; i < s_len && base + i < n; i += blockDim.x)
    perm[row * n + base + i] = (uint16_t)own.p(i);
  K12_MARK(16);
}

// out[op][row, i] = in[op][row, perm[row, i]], one CTA per (row, payload):
// the first `staged` values of the input row are read into shared memory
// coalesced, and the gather reads them there (the rest, a tail of rows
// longer than shared memory holds, through L1); perm is read and the output
// written coalesced
__global__ void __launch_bounds__(kGatherThreads, 1)
    staged_gather_kernel(const uint16_t* __restrict__ perm, Payloads pay, int ops, int n,
                         int staged) {
  extern __shared__ __align__(16) uint32_t vals[];
  const size_t row = blockIdx.x / ops;
  const int op = blockIdx.x % ops;
  const uint32_t* __restrict__ in = pay.in[op] + row * n;
  uint32_t* __restrict__ out = pay.out[op] + row * n;
  const uint16_t* __restrict__ prow = perm + row * n;
  const int t = threadIdx.x, nt = blockDim.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) ==
                       0 && (reinterpret_cast<uintptr_t>(prow) & 7) == 0;
  int head = 0;  // values staged and slots gathered by 16-byte accesses
  if (vec) {
    head = staged & ~3;
    const uint4* in4 = reinterpret_cast<const uint4*>(in);
#pragma unroll 4
    for (int i = t; i < head / 4; i += nt) reinterpret_cast<uint4*>(vals)[i] = __ldg(in4 + i);
  }
  for (int i = head + t; i < staged; i += nt) vals[i] = __ldg(in + i);
  __syncthreads();
  if (vec) {
    head = n & ~3;
    const uint2* p4 = reinterpret_cast<const uint2*>(prow);
#pragma unroll 4
    for (int i = t; i < head / 4; i += nt) {
      const uint2 s2 = __ldg(p4 + i);
      const uint32_t s[4] = {s2.x & 0xffffu, s2.x >> 16, s2.y & 0xffffu, s2.y >> 16};
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = s[u] < (uint32_t)staged ? vals[s[u]] : __ldg(in + s[u]);
      reinterpret_cast<uint4*>(out)[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  for (int i = head + t; i < n; i += nt) {
    const uint32_t s = __ldg(prow + i);
    out[i] = s < (uint32_t)staged ? vals[s] : __ldg(in + s);
  }
}

template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int grid, int cluster, int threads,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the cluster route's shape: C CTAs of S pairs a row, C * S >= n
struct ClusterShape {
  int c, s;
};

ClusterShape cluster_shape(int n) {
  ClusterShape sh{1, 512};
  while (sh.s < n && sh.s < kSlice) sh.s <<= 1;
  while (sh.c * sh.s < n) sh.c <<= 1;
  return sh;
}

cudaError_t launch_cluster_sort(const float* keys, const int* tie, int rows, int n,
                             uint16_t* perm, cudaStream_t s) {
  const ClusterShape sh = cluster_shape(n);
  return launch_cluster(cluster_sort_kernel, sh.c * rows, sh.c, sh.s / kItems,
                        2 * pairs_bytes(sh.s), s, keys, tie, n, perm);
}

cudaError_t launch_staged_gather(const uint16_t* perm, const Payloads& pay, int ops, int rows,
                                 int n, cudaStream_t s) {
  const int staged = n < kMaxSmem / 4 ? n : kMaxSmem / 4;
  const size_t smem = (size_t)staged * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(staged_gather_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  staged_gather_kernel<<<rows * ops, kGatherThreads, smem, s>>>(perm, pay, ops, n, staged);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bitonic route

constexpr int kTile = 4096;  // triples a CTA sorts in shared memory
constexpr int kStepThreads = 256;

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
  extern __shared__ int tsmem[];
  float* k = reinterpret_cast<float*>(tsmem);
  int* t = tsmem + tile;
  int* p = tsmem + 2 * tile;
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
  extern __shared__ int tsmem[];
  float* k = reinterpret_cast<float*>(tsmem);
  int* t = tsmem + tile;
  int* p = tsmem + 2 * tile;
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

bool bad_args(int ops, int rows, int n) {
  return ops < 1 || ops > kMaxOps || rows < 0 || rows > 65535 || n < 0 || n >= (1 << 30);
}

Payloads payloads(const void* const* ins, void* const* outs, int ops) {
  Payloads pay = {};
  for (int op = 0; op < ops; ++op) {
    pay.in[op] = (const uint32_t*)ins[op];
    pay.out[op] = (uint32_t*)outs[op];
  }
  return pay;
}

}  // namespace

// The cluster route: sort rows x n keys (n <= 65536); ins / outs: host arrays
// of `ops` device pointers to (rows, n) 32-bit payloads, ins[ops - 1] the
// int32 tie-break; scratch: rows * n uint16 (the sorted positions). Returns
// the first CUDA error of the two launches.
extern "C" int hept_sort_rows_cluster(const float* keys, const void* const* ins,
                                      void* const* outs, int ops, int rows, int n,
                                      uint16_t* scratch, void* stream) {
  if (bad_args(ops, rows, n) || n > kClusterMaxN) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_cluster_sort(keys, (const int*)ins[ops - 1], rows, n, scratch, s);
  if (err == cudaSuccess)
    err = launch_staged_gather(scratch, payloads(ins, outs, ops), ops, rows, n, s);
  return (int)err;
}

// The bitonic route: the same sort for any n < 2^30; scratch: 3 * rows *
// n_pad 4-byte words, n_pad a power of two >= max(n, 2). Returns the first
// CUDA error of the launches.
extern "C" int hept_bitonic_sort_rows(const float* keys, const void* const* ins,
                                      void* const* outs, int ops, int rows, int n, int n_pad,
                                      void* scratch, void* stream) {
  if (bad_args(ops, rows, n) || n_pad < 2 || n_pad < n || (n_pad & (n_pad - 1)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Payloads pay = payloads(ins, outs, ops);
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
