// Native subgraph-extraction engine.
//
// TPU-native rebuild of the capability the reference outsources to DGL's
// C++ graph store (G-Meta/subgraph_data_processing.py:300-319: per-node
// python loops over G.in_edges / G.subgraph). Semantics mirror
// gmeta_tpu/data/extract.py (the numpy oracle):
//   - h-hop in-neighborhood BFS with dedup, h in {1,2,3} (also any h >= 1)
//   - sample_nodes cap: uniform sample without replacement, centers re-added
//     (cap_strategy=0); or degree-centrality scoring — keep the sample_nodes
//     highest in-degree nodes, ties by node id (cap_strategy=1)
//   - induced subgraph on sorted-unique nodes, relabeled 0..n-1, edges
//     emitted sorted by destination (pack.py contract)
//   - link-pred variant: union of both endpoints' 2-hop neighborhoods
//
// Exposed as a C ABI for ctypes (no pybind11 in the image). Batch
// extraction fans out over a std::thread pool; each thread keeps a
// timestamped visited[] per graph so repeated extractions are O(frontier),
// not O(V).
//
// Build: at first use, by gmeta_tpu_torch/ops/cuda_build.py build_host
// ("extract"): g++ -O3 -std=c++17 -fPIC -pthread -shared, without
// -march=native (the library may be loaded on another host than the one
// that built it; the engine is integer code, so the flag changes no
// result), into build/gmeta_tpu_torch/extract-<hash>.so.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Graph {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  int64_t num_nodes() const { return (int64_t)indptr.size() - 1; }
};

struct Result {
  std::vector<int64_t> parents;   // sorted unique parent ids
  std::vector<int32_t> centers;   // local center indices (1 or 2)
  std::vector<int32_t> esrc, edst;  // induced edges, dst nondecreasing
};

struct Engine {
  std::vector<Graph> graphs;
  std::vector<Result> results;
  std::mutex mu;
};

// Per-thread scratch: timestamped visited marks, one per graph.
struct Scratch {
  std::vector<std::vector<int32_t>> stamp;  // [graph][node] last visit tag
  std::vector<int32_t> tag;
  void ensure(const std::vector<Graph>& gs) {
    if (stamp.size() != gs.size()) {
      stamp.assign(gs.size(), {});
      tag.assign(gs.size(), 0);
    }
    for (size_t i = 0; i < gs.size(); i++)
      if ((int64_t)stamp[i].size() != gs[i].num_nodes())
        stamp[i].assign(gs[i].num_nodes(), 0);
  }
};

void neighborhood(const Graph& g, Scratch& sc, int gi, int64_t center,
                  int hops, std::vector<int64_t>* out) {
  auto& stamp = sc.stamp[gi];
  int32_t tag = ++sc.tag[gi];
  out->clear();
  out->push_back(center);
  stamp[center] = tag;
  size_t frontier_begin = 0;
  for (int hop = 0; hop < hops; hop++) {
    size_t frontier_end = out->size();
    for (size_t i = frontier_begin; i < frontier_end; i++) {
      int64_t v = (*out)[i];
      for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; e++) {
        int32_t u = g.indices[e];
        if (stamp[u] != tag) {
          stamp[u] = tag;
          out->push_back(u);
        }
      }
    }
    frontier_begin = frontier_end;
  }
}

void extract_one(const Graph& g, Scratch& sc, int gi, int64_t c1, int64_t c2,
                 int hops, int64_t sample_nodes, uint64_t seed,
                 int32_t cap_strategy, Result* res) {
  std::vector<int64_t> nodes;
  if (c2 >= 0) {
    // link-pred: union of 2-hop neighborhoods of both endpoints
    // (subgraph_data_processing.py:323-339 hardcodes 2 hops)
    std::vector<int64_t> a, b;
    neighborhood(g, sc, gi, c1, 2, &a);
    neighborhood(g, sc, gi, c2, 2, &b);
    nodes = std::move(a);
    std::sort(nodes.begin(), nodes.end());
    for (int64_t v : b)
      if (!std::binary_search(nodes.begin(), nodes.end(), v))
        nodes.push_back(v);
  } else {
    neighborhood(g, sc, gi, c1, hops, &nodes);
  }

  if ((int64_t)nodes.size() > sample_nodes) {
    if (cap_strategy == 1) {
      // degree-centrality scoring: keep top-sample_nodes by in-degree,
      // deterministic, ties by node id (matches extract.py _cap "degree")
      auto deg = [&](int64_t v) { return g.indptr[v + 1] - g.indptr[v]; };
      std::nth_element(nodes.begin(), nodes.begin() + sample_nodes,
                       nodes.end(), [&](int64_t a, int64_t b) {
                         int64_t da = deg(a), db = deg(b);
                         return da != db ? da > db : a < b;
                       });
    } else {
      // uniform sample without replacement (partial Fisher-Yates), then
      // force-re-add the center(s) (:312-314,337-339)
      std::mt19937_64 rng(seed);
      for (int64_t i = 0; i < sample_nodes; i++) {
        std::uniform_int_distribution<int64_t> d(i, (int64_t)nodes.size() - 1);
        std::swap(nodes[i], nodes[d(rng)]);
      }
    }
    nodes.resize(sample_nodes);
    if (std::find(nodes.begin(), nodes.end(), c1) == nodes.end())
      nodes.push_back(c1);
    if (c2 >= 0 && std::find(nodes.begin(), nodes.end(), c2) == nodes.end())
      nodes.push_back(c2);
  }

  std::sort(nodes.begin(), nodes.end());
  nodes.erase(std::unique(nodes.begin(), nodes.end()), nodes.end());
  res->parents = nodes;

  auto local = [&](int64_t v) {
    return (int32_t)(std::lower_bound(nodes.begin(), nodes.end(), v) -
                     nodes.begin());
  };
  res->centers.clear();
  res->centers.push_back(local(c1));
  if (c2 >= 0) res->centers.push_back(local(c2));

  // induced edges: for each kept node v (ascending), its in-neighbors that
  // are also kept -> (u_local, v_local); dst nondecreasing by construction
  res->esrc.clear();
  res->edst.clear();
  for (size_t vi = 0; vi < nodes.size(); vi++) {
    int64_t v = nodes[vi];
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; e++) {
      int64_t u = g.indices[e];
      auto it = std::lower_bound(nodes.begin(), nodes.end(), u);
      if (it != nodes.end() && *it == u) {
        res->esrc.push_back((int32_t)(it - nodes.begin()));
        res->edst.push_back((int32_t)vi);
      }
    }
  }
}

}  // namespace

extern "C" {

void* gx_new() { return new Engine(); }

void gx_free(void* h) { delete static_cast<Engine*>(h); }

void gx_add_graph(void* h, const int64_t* indptr, const int32_t* indices,
                  int64_t num_nodes, int64_t num_edges) {
  auto* e = static_cast<Engine*>(h);
  Graph g;
  g.indptr.assign(indptr, indptr + num_nodes + 1);
  g.indices.assign(indices, indices + num_edges);
  e->graphs.push_back(std::move(g));
}

// items: n x 3 int64 rows (graph, center1, center2-or-minus1).
// Returns result ids (= row index into an internal result table).
void gx_extract_batch(void* h, const int64_t* items, int64_t n_items,
                      int32_t hops, int64_t sample_nodes, uint64_t seed,
                      int32_t cap_strategy, int32_t n_threads,
                      int64_t* out_ids) {
  auto* eng = static_cast<Engine*>(h);
  size_t base;
  {
    std::lock_guard<std::mutex> lock(eng->mu);
    base = eng->results.size();
    eng->results.resize(base + n_items);
  }
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    Scratch sc;
    sc.ensure(eng->graphs);
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_items) break;
      int64_t gi = items[3 * i], c1 = items[3 * i + 1], c2 = items[3 * i + 2];
      // Per-item RNG stream derived from the item's CONTENT (graph +
      // centers), never its batch position: extraction is then a pure
      // function of (graph set, name, seed) — independent of call order,
      // batching, cache state, and PYTHONHASHSEED (set-order) upstream.
      uint64_t s = seed;
      s = (s ^ (uint64_t)(gi + 1)) * 0x9E3779B97F4A7C15ULL;
      s = (s ^ (uint64_t)(c1 + 1)) * 0x9E3779B97F4A7C15ULL;
      s = (s ^ (uint64_t)(c2 + 1)) * 0x9E3779B97F4A7C15ULL;
      extract_one(eng->graphs[gi], sc, (int)gi, c1, c2, hops, sample_nodes,
                  s, cap_strategy, &eng->results[base + i]);
      out_ids[i] = (int64_t)(base + i);
    }
  };
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < n_threads - 1; t++) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

void gx_result_sizes(void* h, int64_t id, int64_t* n_nodes, int64_t* n_edges,
                     int64_t* n_centers) {
  auto* e = static_cast<Engine*>(h);
  const Result& r = e->results[id];
  *n_nodes = (int64_t)r.parents.size();
  *n_edges = (int64_t)r.esrc.size();
  *n_centers = (int64_t)r.centers.size();
}

void gx_result_fetch(void* h, int64_t id, int64_t* parents, int32_t* centers,
                     int32_t* esrc, int32_t* edst) {
  auto* e = static_cast<Engine*>(h);
  const Result& r = e->results[id];
  std::memcpy(parents, r.parents.data(), r.parents.size() * sizeof(int64_t));
  std::memcpy(centers, r.centers.data(), r.centers.size() * sizeof(int32_t));
  std::memcpy(esrc, r.esrc.data(), r.esrc.size() * sizeof(int32_t));
  std::memcpy(edst, r.edst.data(), r.edst.size() * sizeof(int32_t));
}

void gx_clear_results(void* h) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> lock(e->mu);
  e->results.clear();
}

}  // extern "C"
