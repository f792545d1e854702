// Native comm-plan compiler: shift-class decomposition of a digraph.
//
// TPU-native sibling of the reference's graph-communicator construction
// (MPI_Dist_graph_create_adjacent in bluefog/common/mpi_context.cc [U] and
// the NCCL controller's grouped send/recv list building [U], SURVEY.md
// §2.4).  Python's plan.py performs the same decomposition; this native
// version is used when available (large graphs / frequent dynamic-topology
// compilation) and is verified against the Python fallback in tests.
//
// C ABI:
//   bf_plan_compile(size, n_edges, srcs, dsts,
//                   out_class_of_edge, out_slot_of_edge) -> n_classes
//     - out_class_of_edge[i]: shift-class index of edge i (classes ordered
//       by ascending shift (dst-src) mod size)
//     - out_slot_of_edge[i]: position of src in dst's ascending in-neighbor
//       list (drives neighbor_allgather placement)
//   Returns -1 on invalid input (self-edge, duplicate edge, out of range).

#include <algorithm>
#include <cstdint>
#include <map>
#include <set>
#include <vector>

extern "C" {

int64_t bf_plan_compile(int64_t size, int64_t n_edges, const int64_t* srcs,
                        const int64_t* dsts, int64_t* out_class_of_edge,
                        int64_t* out_slot_of_edge) {
  if (size <= 0 || n_edges < 0) return -1;
  std::vector<std::vector<int64_t>> in_neighbors(size);
  std::set<std::pair<int64_t, int64_t>> seen;
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t s = srcs[i], d = dsts[i];
    if (s < 0 || s >= size || d < 0 || d >= size || s == d) return -1;
    if (!seen.insert({s, d}).second) return -1;  // duplicate edge
    in_neighbors[d].push_back(s);
  }
  for (auto& v : in_neighbors) std::sort(v.begin(), v.end());

  // shift -> dense class index, ordered by ascending shift
  std::map<int64_t, int64_t> class_of_shift;
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t shift = ((dsts[i] - srcs[i]) % size + size) % size;
    class_of_shift.emplace(shift, 0);
  }
  int64_t idx = 0;
  for (auto& kv : class_of_shift) kv.second = idx++;

  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t shift = ((dsts[i] - srcs[i]) % size + size) % size;
    out_class_of_edge[i] = class_of_shift[shift];
    const auto& nb = in_neighbors[dsts[i]];
    out_slot_of_edge[i] =
        std::lower_bound(nb.begin(), nb.end(), srcs[i]) - nb.begin();
  }
  return idx;
}

}  // extern "C"
