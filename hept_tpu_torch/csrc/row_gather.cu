// Flat row gather (K5, which also carries K11's contract): the [num|denom]
// unsort of every HEPT layer, forward and backward, and the sort-carry
// transport of the row-major core.
//
// Replaces the TPU's row-gather kernels
//   K5   hept_tpu/ops/gather_pallas.py:_dma_kernel via row_gather_dma (pallas_call at :208)
//   K11  hept_tpu/ops/gather_pallas.py:_vreg_kernel via row_gather_vreg (pallas_call at :124)
// Both compute out[r, p, :] = src[r % S, idx[r, p], :] with S | R.
//
// Layout: src (S, n, W) and out (R, n, W), row-major, elements of 2 or 4
// bytes copied bit for bit (so the kernel sees rows of `row_bytes` bytes and
// never looks at the values); idx (R, n) int64, read as the static plan
// holds it. The rows the paths move: 400 B (bf16, W = 200; hept_acc,
// hept_fast, eval; R = S = 2, n = 60416), 800 B (the same in f32), 100 B
// (f32 W = dv + 1 = 25; the parity unsort, R = S = 24, n = 60000), 120 B
// and 96 B (f32 d = 30 and dv = 24; the row-major core's transport, R = 24
// from S = 8 broadcast sources). There is no 128-word cap as on the TPU.
//
// What the TPU kernel did: one DMA per row from HBM into a VMEM output tile,
// 16 in flight, and the vreg variant swept the source through VMEM. On
// Hopper the gather is a copy bound by bytes, as long as enough loads are
// in flight: R*n*(row_bytes + 8) + S*n*row_bytes bytes (each output row
// written once, each index read once, each source row read once), at
// 3.35 TB/s 0.029 ms for the 400 B bf16 call and 0.089 ms for the parity
// unsort's 100 B rows.
//
// The design, per CTA tile of T consecutive output rows (T*row_bytes about
// 12 KB):
// 1. the tile's T int64 indices are read with one coalesced load (one
//    thread per row) into shared memory, before any row is copied, so no
//    row waits on its own index;
// 2. rows whose width is a multiple of 16 bytes, with both bases 16-byte
//    aligned (400, 800, 96 B), are copied directly with 16-byte loads and
//    stores: the tile's T*row_bytes/16 vectors are spread over all 256
//    threads, so no lane idles on a row's ragged end, and each thread issues
//    up to four loads before its first store;
// 3. other widths (100 and 120 B, odd bf16 widths) read each source row with
//    the widest access its alignment allows (8, 4 or 2 bytes) into shared
//    memory, placed as the rows lie in the output, whose tile is one
//    contiguous byte range; the tile then leaves through 16-byte stores over
//    its aligned middle and narrow ones at its ragged head and tail. Each
//    thread has up to 16 loads in flight.
// Rows wider than the stage take the direct copy at their own access width.
//
// An index outside [0, n) breaks the contract (the static plan's indices are
// permutations); the kernel then writes zeros instead of reading out of
// bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 12288;  // output bytes per CTA tile
constexpr int kMaxTileRows = 512;

// Byte offset of each tile row's source row, or -1 for a zero row.
__device__ void load_sources(long long* base, const int64_t* __restrict__ idx, long long row0,
                             int nrows, long long n, int s_rounds, long long row_bytes) {
  for (int t = threadIdx.x; t < nrows; t += kThreads) {
    const long long row = row0 + t;
    const long long j = idx[row];
    const long long r = row / n;
    base[t] = (j >= 0 && j < n) ? ((r % s_rounds) * n + j) * row_bytes : -1;
  }
  __syncthreads();
}

// Loads (and stores) each thread keeps in flight: 64 bytes, at most 16.
template <typename E>
__host__ __device__ constexpr int unroll() {
  return 64 / (int)sizeof(E) < 16 ? 64 / (int)sizeof(E) : 16;
}

// Rows of `elems` elements E, both bases E-aligned: element q of the tile is
// element q % elems of tile row q / elems.
template <typename E>
__global__ void row_gather_kernel(const char* __restrict__ src, const int64_t* __restrict__ idx,
                                  E* __restrict__ out, long long rows, long long n, int s_rounds,
                                  int elems, int tile_rows) {
  __shared__ long long base[kMaxTileRows];
  constexpr int U = unroll<E>();
  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int nrows = (int)min((long long)tile_rows, rows - row0);
  load_sources(base, idx, row0, nrows, n, s_rounds, (long long)elems * sizeof(E));
  const int total = nrows * elems;
  E* o = out + row0 * elems;
  for (int q0 = threadIdx.x; q0 < total; q0 += kThreads * U) {
    E buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kThreads;
      buf[u] = E{};
      if (q < total) {
        const int t = q / elems;
        const long long b = base[t];
        if (b >= 0) buf[u] = __ldg(reinterpret_cast<const E*>(src + b) + (q - t * elems));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kThreads;
      if (q < total) o[q] = buf[u];
    }
  }
}

// Rows of any even width up to kTileBytes, read E-wide into a shared stage
// laid out as the tile's output bytes (stage byte s <-> output address
// floor16(a) + s), then written with 16-byte stores where the output is
// 16-byte aligned and E-wide stores at the ends.
template <typename E>
__global__ void row_gather_staged_kernel(const char* __restrict__ src,
                                         const int64_t* __restrict__ idx, char* __restrict__ out,
                                         long long rows, long long n, int s_rounds,
                                         int row_bytes, int tile_rows) {
  __shared__ long long base[kMaxTileRows];
  __shared__ __align__(16) char stage[kTileBytes + 16];
  constexpr int U = unroll<E>();
  constexpr int kE = sizeof(E);
  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int nrows = (int)min((long long)tile_rows, rows - row0);
  load_sources(base, idx, row0, nrows, n, s_rounds, row_bytes);
  const int elems = row_bytes / kE;
  const int total = nrows * elems;
  char* const a = out + row0 * row_bytes;  // the tile's first output byte
  char* const st = stage + ((uintptr_t)a & 15);
  for (int q0 = threadIdx.x; q0 < total; q0 += kThreads * U) {
    E buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kThreads;
      buf[u] = E{};
      if (q < total) {
        const int t = q / elems;
        const long long b = base[t];
        if (b >= 0) buf[u] = __ldg(reinterpret_cast<const E*>(src + b) + (q - t * elems));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kThreads;
      if (q < total) reinterpret_cast<E*>(st)[q] = buf[u];
    }
  }
  __syncthreads();
  const int nbytes = nrows * row_bytes;
  // [0, head) and [tail, nbytes) go out E-wide, [head, tail) 16 bytes at a time
  const int head = min(nbytes, (int)((16 - ((uintptr_t)a & 15)) & 15));
  const int tail = max(head, nbytes - (int)(((uintptr_t)a + nbytes) & 15));
  for (int s = head + 16 * threadIdx.x; s < tail; s += 16 * kThreads)
    *reinterpret_cast<uint4*>(a + s) = *reinterpret_cast<const uint4*>(st + s);
  const int ragged = head / kE + (nbytes - tail) / kE;
  for (int i = threadIdx.x; i < ragged; i += kThreads) {
    const int s = i < head / kE ? i * kE : tail + (i - head / kE) * kE;
    *reinterpret_cast<E*>(a + s) = *reinterpret_cast<const E*>(st + s);
  }
}

int tile_rows_for(long long row_bytes) {
  const long long t = kTileBytes / row_bytes;
  return (int)(t < 1 ? 1 : (t > kMaxTileRows ? kMaxTileRows : t));
}

template <typename E>
int launch_direct(const void* src, const int64_t* idx, void* out, long long rows, long long n,
                  int s_rounds, long long row_bytes, cudaStream_t st) {
  const int t = tile_rows_for(row_bytes);
  const long long blocks = (rows + t - 1) / t;
  row_gather_kernel<E><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const char*)src, idx, (E*)out, rows, n, s_rounds, (int)(row_bytes / sizeof(E)), t);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_staged(const void* src, const int64_t* idx, void* out, long long rows, long long n,
                  int s_rounds, long long row_bytes, cudaStream_t st) {
  if (row_bytes > kTileBytes) return launch_direct<E>(src, idx, out, rows, n, s_rounds,
                                                      row_bytes, st);
  const int t = tile_rows_for(row_bytes);
  const long long blocks = (rows + t - 1) / t;
  row_gather_staged_kernel<E><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const char*)src, idx, (char*)out, rows, n, s_rounds, (int)row_bytes, t);
  return (int)cudaGetLastError();
}

}  // namespace

// out[r, p, :] = src[r % s_rounds, idx[r, p], :] for r < rows / n; rows of
// `row_bytes` bytes (even). Returns the CUDA error code of the launch.
extern "C" int hept_row_gather(const void* src, const int64_t* idx, void* out, long long rows,
                               long long n, int s_rounds, long long row_bytes, void* stream) {
  if (rows == 0 || row_bytes == 0) return 0;
  if (n <= 0 || s_rounds <= 0 || row_bytes % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the widest access that divides the row and both bases
  const uintptr_t g = (uintptr_t)src | (uintptr_t)out | (uintptr_t)row_bytes;
  if (g % 16 == 0) return launch_direct<uint4>(src, idx, out, rows, n, s_rounds, row_bytes, st);
  if (g % 8 == 0) return launch_staged<uint2>(src, idx, out, rows, n, s_rounds, row_bytes, st);
  if (g % 4 == 0)
    return launch_staged<uint32_t>(src, idx, out, rows, n, s_rounds, row_bytes, st);
  if (g % 2 == 0)
    return launch_staged<uint16_t>(src, idx, out, rows, n, s_rounds, row_bytes, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hept_row_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
