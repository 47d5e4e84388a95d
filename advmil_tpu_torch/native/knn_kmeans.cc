// Host-side exact kNN and KMeans (Lloyd + kmeans++ init) for the offline
// graph and cluster tools of advmil_tpu_torch (tools/build_graphs.py,
// tools/cluster_patches.py); a copy of advmil_tpu/native/knn_kmeans.cc, so
// that both packages build the same graphs and clusters.
//
// Fills the role of the reference's third-party native deps in the offline
// preprocessing tools: nmslib's C++ HNSW for graph construction
// (reference tools/patchgcn_graph_s2.py:19,30-92) and scikit-learn's Cython
// KMeans for patch clustering (reference tools/deepattnmisl_cluster.py:17,54).
// Exact (not approximate) kNN: WSI graphs use radius-9 neighborhoods where
// HNSW recall noise changes the graph; exact blocked search is fast enough
// at WSI scale and deterministic.
//
// Built at first use by advmil_tpu_torch/native/__init__.py:
//   g++ -O3 -std=c++17 -shared -fPIC -pthread knn_kmeans.cc -o <lib>.so
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <random>
#include <thread>
#include <vector>

namespace {

inline float l2_sq(const float* a, const float* b, int d) {
  float acc = 0.f;
  for (int i = 0; i < d; ++i) {
    const float diff = a[i] - b[i];
    acc += diff * diff;
  }
  return acc;
}

void knn_rows(const float* X, int64_t n, int d, int k, int64_t row_lo,
              int64_t row_hi, int32_t* out_idx, float* out_dist) {
  std::vector<std::pair<float, int32_t>> heap;
  heap.reserve(k + 1);
  for (int64_t i = row_lo; i < row_hi; ++i) {
    heap.clear();
    const float* xi = X + i * d;
    for (int64_t j = 0; j < n; ++j) {
      const float dist = l2_sq(xi, X + j * d, d);
      if ((int)heap.size() < k) {
        heap.emplace_back(dist, (int32_t)j);
        std::push_heap(heap.begin(), heap.end());
      } else if (dist < heap.front().first) {
        std::pop_heap(heap.begin(), heap.end());
        heap.back() = {dist, (int32_t)j};
        std::push_heap(heap.begin(), heap.end());
      }
    }
    std::sort_heap(heap.begin(), heap.end());
    for (int m = 0; m < k; ++m) {
      const bool have = m < (int)heap.size();
      out_idx[i * k + m] = have ? heap[m].second : -1;
      if (out_dist) out_dist[i * k + m] =
          have ? heap[m].first : std::numeric_limits<float>::infinity();
    }
  }
}

}  // namespace

extern "C" {

// Exact kNN under L2: for each of n points, the k nearest (self included,
// since d(x,x)=0 sorts first — callers strip column 0, mirroring the
// reference's query(...)[1:]).
void advmil_knn_l2(const float* X, int64_t n, int32_t d, int32_t k,
                   int32_t* out_idx, float* out_dist, int32_t n_threads) {
  if (n_threads <= 0)
    n_threads = (int32_t)std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min<int32_t>(n_threads, (int32_t)std::max<int64_t>(n, 1));
  std::vector<std::thread> workers;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(knn_rows, X, n, d, k, lo, hi, out_idx, out_dist);
  }
  for (auto& w : workers) w.join();
}

// KMeans (Lloyd) with kmeans++ initialization. Deterministic for a given
// seed. labels: [n], centroids: [k*d] (outputs).
void advmil_kmeans(const float* X, int64_t n, int32_t d, int32_t k,
                   int32_t max_iter, uint32_t seed, int32_t* labels,
                   float* centroids) {
  std::mt19937 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);

  // kmeans++ seeding
  std::vector<double> dist2(n, std::numeric_limits<double>::infinity());
  {
    std::uniform_int_distribution<int64_t> pick(0, n - 1);
    int64_t first = pick(rng);
    std::memcpy(centroids, X + first * d, sizeof(float) * d);
  }
  for (int c = 1; c < k; ++c) {
    double total = 0.0;
    const float* prev = centroids + (int64_t)(c - 1) * d;
    for (int64_t i = 0; i < n; ++i) {
      const double dd = (double)l2_sq(X + i * d, prev, d);
      if (dd < dist2[i]) dist2[i] = dd;
      total += dist2[i];
    }
    double r = unif(rng) * total;
    int64_t chosen = n - 1;
    double acc = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      acc += dist2[i];
      if (acc >= r) { chosen = i; break; }
    }
    std::memcpy(centroids + (int64_t)c * d, X + chosen * d, sizeof(float) * d);
  }

  std::vector<double> sums((int64_t)k * d);
  std::vector<int64_t> counts(k);
  for (int iter = 0; iter < max_iter; ++iter) {
    bool changed = false;
    for (int64_t i = 0; i < n; ++i) {
      float best = std::numeric_limits<float>::infinity();
      int32_t best_c = 0;
      for (int c = 0; c < k; ++c) {
        const float dd = l2_sq(X + i * d, centroids + (int64_t)c * d, d);
        if (dd < best) { best = dd; best_c = c; }
      }
      if (iter == 0 || labels[i] != best_c) changed = true;
      labels[i] = best_c;
    }
    if (!changed && iter > 0) break;
    std::fill(sums.begin(), sums.end(), 0.0);
    std::fill(counts.begin(), counts.end(), 0);
    for (int64_t i = 0; i < n; ++i) {
      const int32_t c = labels[i];
      counts[c]++;
      for (int j = 0; j < d; ++j) sums[(int64_t)c * d + j] += X[i * d + j];
    }
    for (int c = 0; c < k; ++c) {
      if (counts[c] == 0) continue;  // keep old centroid for empty clusters
      for (int j = 0; j < d; ++j)
        centroids[(int64_t)c * d + j] = (float)(sums[(int64_t)c * d + j] / counts[c]);
    }
  }
}

}  // extern "C"
