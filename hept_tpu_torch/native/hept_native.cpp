// Native host-side kernels of the hept_tpu_torch input pipeline: the port's
// own copy of the JAX package's `hept_tpu/native/hept_native.cpp`, the same
// source, so that both build the same pairs on one host.
//
// The reference delegates its host-side hot loops to third-party native code
// (torch_cluster radius/knn graphs for supervision pairs). Here the
// equivalents are first-party C++ with ctypes bindings
// (hept_tpu_torch/native/__init__.py): a grid-hash radius-neighbour pair
// search (replaces torch_cluster.radius on the data path,
// reference src/datasets/tracking.py:204-209) and a dense event packer that
// fills padded (N_max, F) buffers + masks without Python-loop overhead.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libhept_native.so hept_native.cpp
// (done at first use by the Python wrapper, into hept_tpu_torch/_build/; no
// external deps).

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Up-to-k neighbours within `radius` (L2 on eta/phi) for every point.
// Writes (src, dst) int32 pairs; returns the number of pairs emitted, or -1
// if max_pairs would be exceeded (caller re-allocates and retries).
int64_t radius_pairs(const float* eta, const float* phi, int64_t n,
                     float radius, int32_t max_k,
                     int32_t* out_src, int32_t* out_dst, int64_t max_pairs) {
  const float r2 = radius * radius;
  const float cell = radius;
  // spatial grid hash: cell -> point indices
  std::unordered_map<int64_t, std::vector<int32_t>> grid;
  grid.reserve(static_cast<size_t>(n));
  auto cell_key = [cell](float x, float y) -> int64_t {
    const int64_t cx = static_cast<int64_t>(std::floor(x / cell));
    const int64_t cy = static_cast<int64_t>(std::floor(y / cell));
    return (cx << 32) ^ (cy & 0xffffffffLL);
  };
  for (int64_t i = 0; i < n; ++i) {
    grid[cell_key(eta[i], phi[i])].push_back(static_cast<int32_t>(i));
  }

  int64_t count = 0;
  std::vector<std::pair<float, int32_t>> cand;
  for (int64_t i = 0; i < n; ++i) {
    cand.clear();
    const int64_t cx = static_cast<int64_t>(std::floor(eta[i] / cell));
    const int64_t cy = static_cast<int64_t>(std::floor(phi[i] / cell));
    for (int64_t dx = -1; dx <= 1; ++dx) {
      for (int64_t dy = -1; dy <= 1; ++dy) {
        const int64_t key = ((cx + dx) << 32) ^ ((cy + dy) & 0xffffffffLL);
        auto it = grid.find(key);
        if (it == grid.end()) continue;
        for (int32_t j : it->second) {
          if (j == i) continue;
          const float de = eta[i] - eta[j];
          const float dp = phi[i] - phi[j];
          const float d2 = de * de + dp * dp;
          if (d2 < r2) cand.emplace_back(d2, j);
        }
      }
    }
    if (static_cast<int32_t>(cand.size()) > max_k) {
      // keep the max_k nearest: partial sort by distance
      std::nth_element(cand.begin(), cand.begin() + max_k, cand.end());
      cand.resize(max_k);
    }
    if (count + static_cast<int64_t>(cand.size()) > max_pairs) return -1;
    for (const auto& [d2, j] : cand) {
      out_src[count] = static_cast<int32_t>(i);
      out_dst[count] = j;
      ++count;
    }
  }
  return count;
}

// Dense batch packing: scatter each event's rows into its padded slot.
// xs: concatenated event features (sum_n, f); sizes: per-event row counts
// (b,); out: (b, n_max, f) zero-initialised by caller; valid: (b, n_max).
void pack_dense(const float* xs, const int64_t* sizes, int64_t b,
                int64_t n_max, int64_t f, float* out, bool* valid) {
  int64_t offset = 0;
  for (int64_t e = 0; e < b; ++e) {
    const int64_t n = sizes[e];
    std::memcpy(out + e * n_max * f, xs + offset * f,
                static_cast<size_t>(n * f) * sizeof(float));
    for (int64_t i = 0; i < n; ++i) valid[e * n_max + i] = true;
    offset += n;
  }
}

// Brute-force top-k nearest neighbours in a small learned space (host-side
// eval helper; the device path uses ops/knn.py). dists/idx are (n, k).
void knn_small(const float* x, int64_t n, int64_t d, int32_t k,
               float* out_d, int32_t* out_i) {
  std::vector<std::pair<float, int32_t>> row(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < n; ++j) {
      float acc = 0.f;
      for (int64_t c = 0; c < d; ++c) {
        const float diff = x[i * d + c] - x[j * d + c];
        acc += diff * diff;
      }
      row[static_cast<size_t>(j)] = {acc, static_cast<int32_t>(j)};
    }
    const int64_t kk = k < n ? k : n;
    std::partial_sort(row.begin(), row.begin() + kk, row.end());
    for (int64_t j = 0; j < kk; ++j) {
      out_d[i * k + j] = row[static_cast<size_t>(j)].first;
      out_i[i * k + j] = row[static_cast<size_t>(j)].second;
    }
    for (int64_t j = kk; j < k; ++j) {
      out_d[i * k + j] = INFINITY;
      out_i[i * k + j] = -1;
    }
  }
}

}  // extern "C"
