// Torus layout optimizer: simulated-annealing search for the rank->chip
// assignment minimizing the weighted ICI hop cost of a gossip topology.
//
// TPU-native sibling of the reference's reliance on MPI rank reordering
// (MPI_Dist_graph_create_adjacent's reorder flag + mpirun placement,
// bluefog/common/mpi_context.cc [U], SURVEY.md §2.4): there the MPI library
// may permute ranks to fit the physical network; here we own the search.
// The snake heuristic (parallel/ici_map.py) is the starting point; this
// annealer improves irregular topologies (exp-2, 2-D mesh on non-square
// tori) where no closed-form embedding exists.  Cost model: sum over
// directed edges of weight * torus-Manhattan hops — link-bandwidth use of
// one gossip round (ici_map.plan_hop_cost's total).
//
// C API (ctypes-friendly, no exceptions across the boundary).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <random>
#include <vector>

namespace {

inline int64_t hop(const int64_t* a, const int64_t* b, const int64_t* shape,
                   int64_t nd) {
  int64_t d = 0;
  for (int64_t i = 0; i < nd; ++i) {
    int64_t x = std::llabs(a[i] - b[i]);
    d += std::min(x, shape[i] - x);
  }
  return d;
}

}  // namespace

extern "C" {

// n ranks live on n candidate positions (coords: n*nd row-major, a
// permutation of torus cells or any subset of them); m directed edges
// (esrc/edst rank ids, ew weights).  assign[r] (in/out) is the position
// index of rank r — seeded with the caller's initial assignment (e.g. the
// snake order), overwritten with the best found.  Returns the best cost,
// or -1.0 on invalid input.
double bf_layout_anneal(int64_t n, int64_t nd, const int64_t* coords,
                        const int64_t* shape, int64_t m, const int64_t* esrc,
                        const int64_t* edst, const double* ew, int64_t iters,
                        uint64_t seed, int64_t* assign) {
  if (n <= 0 || nd <= 0 || m < 0 || iters < 0) return -1.0;
  std::vector<char> seen(static_cast<size_t>(n), 0);
  for (int64_t r = 0; r < n; ++r) {
    if (assign[r] < 0 || assign[r] >= n || seen[assign[r]]) return -1.0;
    seen[assign[r]] = 1;
  }
  for (int64_t e = 0; e < m; ++e) {
    if (esrc[e] < 0 || esrc[e] >= n || edst[e] < 0 || edst[e] >= n ||
        esrc[e] == edst[e])
      return -1.0;
  }

  // incidence lists so a swap's delta touches only local edges
  std::vector<std::vector<int64_t>> inc(static_cast<size_t>(n));
  for (int64_t e = 0; e < m; ++e) {
    inc[esrc[e]].push_back(e);
    if (edst[e] != esrc[e]) inc[edst[e]].push_back(e);
  }

  std::vector<int64_t> pos(assign, assign + n);
  auto edge_cost = [&](int64_t e) {
    return ew[e] * static_cast<double>(hop(coords + pos[esrc[e]] * nd,
                                           coords + pos[edst[e]] * nd, shape,
                                           nd));
  };
  double cost = 0.0;
  for (int64_t e = 0; e < m; ++e) cost += edge_cost(e);

  std::vector<int64_t> best(pos);
  double best_cost = cost;
  if (n < 2 || m == 0 || iters == 0) return best_cost;

  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int64_t> pick(0, n - 1);
  std::uniform_real_distribution<double> unit(0.0, 1.0);

  // geometric cooling from the mean edge cost down to ~1e-3 of it
  double t0 = std::max(cost / std::max<int64_t>(m, 1), 1e-9);
  double t_end = t0 * 1e-3;
  double decay = std::pow(t_end / t0, 1.0 / static_cast<double>(iters));
  double temp = t0;

  for (int64_t it = 0; it < iters; ++it, temp *= decay) {
    int64_t r1 = pick(rng);
    int64_t r2 = pick(rng);
    if (r1 == r2) continue;
    double before = 0.0;
    for (int64_t e : inc[r1]) before += edge_cost(e);
    for (int64_t e : inc[r2])
      if (esrc[e] != r1 && edst[e] != r1) before += edge_cost(e);
    std::swap(pos[r1], pos[r2]);
    double after = 0.0;
    for (int64_t e : inc[r1]) after += edge_cost(e);
    for (int64_t e : inc[r2])
      if (esrc[e] != r1 && edst[e] != r1) after += edge_cost(e);
    double delta = after - before;
    if (delta <= 0.0 || unit(rng) < std::exp(-delta / temp)) {
      cost += delta;
      if (cost < best_cost) {
        best_cost = cost;
        best = pos;
      }
    } else {
      std::swap(pos[r1], pos[r2]);  // reject
    }
  }
  for (int64_t r = 0; r < n; ++r) assign[r] = best[r];
  return best_cost;
}

}  // extern "C"
