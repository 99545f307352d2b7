// Native host engine of the PyTorch port: multi-threaded approximate-PPR
// precompute.  The port's own copy of shadow_gnn_tpu/native/ppr.cpp, with
// the same C ABI and the same numerics, so both packages give identical
// tables.
//
// Sampling and induction run on the GPU; the one host-bound job left is
// the one-time per-target forward-push PPR precompute (reference:
// ParallelSampler.cpp:237-344, OpenMP `parallel for` over targets).  This
// library provides that with std::thread work-stealing, identical
// numerics:
//   * lazy push: pi[v] += a*res; spread (1-a)*res/(2*deg) to neighbors;
//     residue[v] <- res*(1-a)/2; settle when residue <= eps*deg
//   * the propagation frontier pops the smallest node id first
//     (std::set semantics in the reference) for determinism — here a
//     lazy min-heap + pending flags, which pops the same id sequence as
//     std::set at a fraction of the allocator/rebalance cost
//   * top-k selected by (-score, node id)
//
// The reference flips to map-based state above 5M nodes
// (ParallelSampler.cpp:252-254) because it never resets dense vectors;
// this engine dirty-tracks its dense state so resets are O(touched),
// making dense state viable to papers100M scale (9 bytes/node/thread:
// pi + residue f32 + pending byte = ~1 GB/thread at 111M nodes; the
// caller picks dense vs map from available memory).
//
// Exposed via a C ABI consumed with ctypes (no pybind11 dependency).
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using NodeT = int32_t;

// min-heap over node ids with lazy dedup: `pending` marks membership, so
// pop() returns exactly the std::set<NodeT> begin() sequence
using MinHeap = std::priority_queue<NodeT, std::vector<NodeT>,
                                    std::greater<NodeT>>;

struct DenseState {
  std::vector<float> pi, res;
  std::vector<uint8_t> pending;
  std::vector<NodeT> dirty_pi, dirty_res;
  explicit DenseState(int64_t n) : pi(n, 0.0f), res(n, 0.0f), pending(n, 0) {}
  void reset() {
    for (NodeT i : dirty_pi) pi[i] = 0.0f;
    for (NodeT i : dirty_res) res[i] = 0.0f;
    dirty_pi.clear();
    dirty_res.clear();
  }
};

// one target's push over dirty-tracked dense vectors; on return,
// st.dirty_pi lists exactly the touched (settled) nodes and st.pi their
// scores (every popped node has settled when the frontier drains)
void push_dense(const int64_t* indptr, const NodeT* indices,
                const std::vector<NodeT>& deg, NodeT target, float alpha,
                float epsilon, DenseState& st, MinHeap& heap) {
  st.res[target] = 1.0f;
  st.dirty_res.push_back(target);
  heap.push(target);
  st.pending[target] = 1;
  while (!heap.empty()) {
    NodeT v = heap.top();
    heap.pop();
    st.pending[v] = 0;
    float res = st.res[v];
    if (st.pi[v] == 0.0f) st.dirty_pi.push_back(v);
    st.pi[v] += alpha * res;
    NodeT dv = deg[v];
    if (dv > 0) {
      float m = (1.0f - alpha) * res / (2.0f * dv);
      for (int64_t i = indptr[v]; i < indptr[v + 1]; ++i) {
        NodeT u = indices[i];
        if (st.res[u] == 0.0f) st.dirty_res.push_back(u);
        st.res[u] += m;
        if (st.res[u] > epsilon * deg[u] && !st.pending[u]) {
          heap.push(u);
          st.pending[u] = 1;
        }
      }
    }
    st.res[v] = res * (1.0f - alpha) / 2.0f;
    if (!(st.res[v] <= epsilon * dv || dv == 0) && !st.pending[v]) {
      heap.push(v);
      st.pending[v] = 1;
    }
  }
}

// sparse-state variant for memory-constrained huge-graph hosts
void push_map(const int64_t* indptr, const NodeT* indices,
              const std::vector<NodeT>& deg, NodeT target, float alpha,
              float epsilon,
              std::vector<std::pair<float, NodeT>>& out_touched) {
  std::unordered_map<NodeT, float> pi, res;
  std::unordered_set<NodeT> pending{target};
  MinHeap heap;
  heap.push(target);
  res[target] = 1.0f;
  while (!heap.empty()) {
    NodeT v = heap.top();
    heap.pop();
    pending.erase(v);
    float r = res[v];
    pi[v] += alpha * r;
    NodeT dv = deg[v];
    if (dv > 0) {
      float m = (1.0f - alpha) * r / (2.0f * dv);
      for (int64_t i = indptr[v]; i < indptr[v + 1]; ++i) {
        NodeT u = indices[i];
        float& ru = res[u];
        ru += m;
        if (ru > epsilon * deg[u] && pending.insert(u).second) heap.push(u);
      }
    }
    res[v] = r * (1.0f - alpha) / 2.0f;
    if (!(res[v] <= epsilon * dv || dv == 0) && pending.insert(v).second)
      heap.push(v);
  }
  out_touched.clear();
  out_touched.reserve(pi.size());
  for (auto& kv : pi) out_touched.push_back({-kv.second, kv.first});
}

}  // namespace

extern "C" {

// out_neighs/out_scores: [n_targets, k], pad = -1 / 0.
// use_dense: 1 = dense per-thread state (9 bytes/node/thread),
//            2 = map state, 0 = auto (dense <= 5M nodes, the reference
//            threshold; callers with memory headroom pass 1 explicitly)
int shadow_ppr_push(const int64_t* indptr, int64_t n_nodes,
                    const int32_t* indices, int64_t n_edges,
                    const int64_t* targets, int64_t n_targets, int k,
                    float alpha_int, float epsilon, int n_threads,
                    int use_dense, int32_t* out_neighs, float* out_scores) {
  std::vector<NodeT> deg(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i)
    deg[i] = static_cast<NodeT>(indptr[i + 1] - indptr[i]);
  const bool dense = use_dense == 1 || (use_dense == 0 && n_nodes <= 5'000'000);
  std::atomic<int64_t> next{0};
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();

  auto worker = [&]() {
    DenseState st(dense ? n_nodes : 0);
    MinHeap heap;
    std::vector<std::pair<float, NodeT>> touched;
    while (true) {
      int64_t ti = next.fetch_add(1);
      if (ti >= n_targets) break;
      NodeT t = static_cast<NodeT>(targets[ti]);
      if (dense) {
        push_dense(indptr, indices, deg, t, alpha_int, epsilon, st, heap);
        touched.clear();
        touched.reserve(st.dirty_pi.size());
        for (NodeT v : st.dirty_pi) touched.push_back({-st.pi[v], v});
        st.reset();
      } else {
        push_map(indptr, indices, deg, t, alpha_int, epsilon, touched);
      }
      // top-k by (-score, id)
      size_t kk = std::min<size_t>(k, touched.size());
      std::partial_sort(touched.begin(), touched.begin() + kk, touched.end());
      int32_t* on = out_neighs + ti * k;
      float* os = out_scores + ti * k;
      for (size_t i = 0; i < (size_t)k; ++i) {
        if (i < kk) {
          on[i] = touched[i].second;
          os[i] = -touched[i].first;
        } else {
          on[i] = -1;
          os[i] = 0.0f;
        }
      }
    }
  };

  std::vector<std::thread> pool;
  for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

// Offsets of the per-row length words in the reference's ragged bin
// layout (header at words [0,4); then per row: u32 length + payload).
// Returns 0 and fills out_pos[cnt], or -1 if the buffer overruns —
// the sequential scan the vectorized python reader cannot express.
int shadow_ragged_offsets(const uint32_t* buf, int64_t total_words,
                          uint32_t cnt, int64_t* out_pos) {
  int64_t pos = 4;
  for (uint32_t i = 0; i < cnt; ++i) {
    if (pos >= total_words) return -1;
    out_pos[i] = pos;
    pos += 1 + static_cast<int64_t>(buf[pos]);
  }
  return pos <= total_words ? 0 : -1;
}

}  // extern "C"
