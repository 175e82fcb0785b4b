// Native host-side runtime of manifold_gp_torch (a copy of
// native/manifold_native.cc, built by manifold_gp_torch.utils.native into the
// package's build directory).
//
// Host equivalents of the reference's C++ dependencies:
//   * FAISS IndexFlatL2 exact kNN  -> blocked, multithreaded brute-force
//     squared-L2 top-k (exact_knn): the "host" backend of
//     ops.graph.build_graph.
//   * torch_sparse.coalesce(op=mean) -> sort-and-merge duplicate edge merge
//     (coalesce_mean).
//   * networkx shortest_path_length  -> binary-heap Dijkstra single-source
//     geodesics over a CSR mesh graph (dijkstra).
//
// Exposed with a plain C ABI for ctypes binding.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// Exact kNN: for each query, the k smallest squared L2 distances (ascending)
// and their indices. Parallelized over query blocks with std::thread.
void exact_knn(const float* db, int64_t n, int64_t d, const float* queries,
               int64_t nq, int64_t k, float* out_dist, int64_t* out_idx) {
  const int64_t kk = std::min<int64_t>(k, n);
  // Precompute db norms.
  std::vector<float> db_norm(n);
  for (int64_t i = 0; i < n; ++i) {
    float s = 0.f;
    const float* row = db + i * d;
    for (int64_t j = 0; j < d; ++j) s += row[j] * row[j];
    db_norm[i] = s;
  }
  unsigned num_threads = std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int64_t> next_query{0};
  auto worker = [&]() {
    std::vector<std::pair<float, int64_t>> heap;  // max-heap of best-k
    std::vector<float> qrow(d);
    for (;;) {
      int64_t qi = next_query.fetch_add(1);
      if (qi >= nq) break;
      const float* q = queries + qi * d;
      float qn = 0.f;
      for (int64_t j = 0; j < d; ++j) qn += q[j] * q[j];
      heap.clear();
      for (int64_t i = 0; i < n; ++i) {
        float dot = 0.f;
        const float* row = db + i * d;
        for (int64_t j = 0; j < d; ++j) dot += row[j] * q[j];
        float dist = qn + db_norm[i] - 2.f * dot;
        if (dist < 0.f) dist = 0.f;
        if ((int64_t)heap.size() < kk) {
          heap.emplace_back(dist, i);
          std::push_heap(heap.begin(), heap.end());
        } else if (dist < heap.front().first) {
          std::pop_heap(heap.begin(), heap.end());
          heap.back() = {dist, i};
          std::push_heap(heap.begin(), heap.end());
        }
      }
      std::sort_heap(heap.begin(), heap.end());
      for (int64_t j = 0; j < kk; ++j) {
        out_dist[qi * k + j] = heap[j].first;
        out_idx[qi * k + j] = heap[j].second;
      }
      for (int64_t j = kk; j < k; ++j) {
        out_dist[qi * k + j] = INFINITY;
        out_idx[qi * k + j] = -1;
      }
    }
  };
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Merge duplicate (row, col) pairs, averaging values. Inputs need not be
// sorted. Returns the number of unique pairs; outputs are sorted by
// (row, col).
int64_t coalesce_mean(const int64_t* rows, const int64_t* cols,
                      const double* vals, int64_t m, int64_t n,
                      int64_t* out_rows, int64_t* out_cols, double* out_vals) {
  std::vector<int64_t> order(m);
  for (int64_t i = 0; i < m; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    int64_t ka = rows[a] * n + cols[a], kb = rows[b] * n + cols[b];
    return ka < kb;
  });
  int64_t out = -1;
  int64_t count = 0;
  int64_t prev_key = -1;
  for (int64_t ii = 0; ii < m; ++ii) {
    int64_t i = order[ii];
    int64_t key = rows[i] * n + cols[i];
    if (key != prev_key) {
      if (out >= 0) out_vals[out] /= count;
      ++out;
      out_rows[out] = rows[i];
      out_cols[out] = cols[i];
      out_vals[out] = vals[i];
      count = 1;
      prev_key = key;
    } else {
      out_vals[out] += vals[i];
      ++count;
    }
  }
  if (out >= 0) out_vals[out] /= count;
  return out + 1;
}

// Single-source Dijkstra over an undirected CSR graph.
void dijkstra(int64_t n, const int64_t* indptr, const int64_t* indices,
              const float* weights, int64_t source, float* dist) {
  for (int64_t i = 0; i < n; ++i) dist[i] = INFINITY;
  dist[source] = 0.f;
  using Item = std::pair<float, int64_t>;
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> pq;
  pq.emplace(0.f, source);
  while (!pq.empty()) {
    auto [du, u] = pq.top();
    pq.pop();
    if (du > dist[u]) continue;
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      int64_t v = indices[e];
      float nd = du + weights[e];
      if (nd < dist[v]) {
        dist[v] = nd;
        pq.emplace(nd, v);
      }
    }
  }
}

}  // extern "C"
