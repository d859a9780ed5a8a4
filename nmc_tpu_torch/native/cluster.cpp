// Native cluster kernels for irregular host-side graph work.
//
// The Houdayer move (the reference's NPT/apt_ICM.py:116-143) needs connected
// components of the disagreement subgraph per sub-replica pair, per replica,
// per swap round — the hottest host-side op in the ICM driver. The reference
// implements it as a Python BFS over dense rows (O(N^2) per call); here it is
// a weighted union-find over a CSR adjacency restricted to an active-node
// mask, plus the backbone-cluster seed/growth pass used by NMC
// (the reference's NMC/nmc.py:257-318) on large instances.
//
// Exposed as a plain C ABI for ctypes (no pybind11); built by
// nmc_tpu_torch/native/__init__.py with g++ -O3 at first use, raising with
// the compiler's output if the build fails. The code is the JAX package's
// nmc_tpu/native/cluster.cpp; only comments differ.

#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  std::vector<int32_t> rank_;

  explicit UnionFind(int32_t n) : parent(n), rank_(n, 0) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }

  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {  // path compression
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }

  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    if (rank_[a] == rank_[b]) ++rank_[a];
  }
};

}  // namespace

extern "C" {

// Connected components of the subgraph induced by active nodes.
//   n         : number of nodes
//   indptr    : CSR row pointers [n+1]
//   indices   : CSR column indices [nnz]
//   active    : per-node mask [n] (int8; 0 = excluded)
//   labels    : out [n]; -1 for inactive nodes, else component id in
//               [0, num_components), ids ordered by smallest member.
// Returns the number of components.
int32_t nmc_connected_components(int32_t n, const int64_t* indptr,
                                 const int32_t* indices, const int8_t* active,
                                 int32_t* labels) {
  UnionFind uf(n);
  for (int32_t i = 0; i < n; ++i) {
    if (!active[i]) continue;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t j = indices[k];
      if (j > i) break;  // CSR columns sorted; each edge once
      if (active[j]) uf.unite(i, j);
    }
  }
  // compact labels in order of first appearance (smallest member first)
  std::vector<int32_t> remap(n, -1);
  int32_t next = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (!active[i]) {
      labels[i] = -1;
      continue;
    }
    int32_t r = uf.find(i);
    if (remap[r] < 0) remap[r] = next++;
    labels[i] = remap[r];
  }
  return next;
}

// Backbone cluster pass (semantics of the reference's NMC/nmc.py:257-318):
// seeds are nodes with |mag| >= threshold_initial; each unclaimed seed
// claims itself plus unclaimed seed-neighbors (cluster ids in seed order);
// then the threshold decays by step down to cutoff, each pass absorbing
// unclaimed neighbors of each cluster with |mag| >= current threshold.
//   cluster_id : out [n]; -1 if unclaimed.
// Returns number of clusters.
int32_t nmc_backbone_clusters(int32_t n, const int64_t* indptr,
                              const int32_t* indices, const double* mag,
                              double threshold_initial,
                              double threshold_cutoff, double threshold_step,
                              int32_t* cluster_id) {
  for (int32_t i = 0; i < n; ++i) cluster_id[i] = -1;
  std::vector<int8_t> is_seed(n, 0);
  for (int32_t i = 0; i < n; ++i) {
    double a = mag[i] < 0 ? -mag[i] : mag[i];
    is_seed[i] = a >= threshold_initial ? 1 : 0;
  }
  int32_t num_clusters = 0;
  std::vector<std::vector<int32_t>> members;
  for (int32_t s = 0; s < n; ++s) {
    if (!is_seed[s] || cluster_id[s] >= 0) continue;
    int32_t cid = num_clusters++;
    members.emplace_back();
    cluster_id[s] = cid;
    members[cid].push_back(s);
    for (int64_t k = indptr[s]; k < indptr[s + 1]; ++k) {
      int32_t j = indices[k];
      if (is_seed[j] && cluster_id[j] < 0) {
        cluster_id[j] = cid;
        members[cid].push_back(j);
      }
    }
  }
  double threshold = threshold_initial - threshold_step;
  while (threshold > threshold_cutoff) {
    for (int32_t cid = 0; cid < num_clusters; ++cid) {
      std::size_t old_size = members[cid].size();
      for (std::size_t mi = 0; mi < old_size; ++mi) {
        int32_t v = members[cid][mi];
        for (int64_t k = indptr[v]; k < indptr[v + 1]; ++k) {
          int32_t j = indices[k];
          if (cluster_id[j] >= 0) continue;
          double a = mag[j] < 0 ? -mag[j] : mag[j];
          if (a >= threshold) {
            cluster_id[j] = cid;
            members[cid].push_back(j);
          }
        }
      }
    }
    threshold -= threshold_step;
  }
  return num_clusters;
}

}  // extern "C"
