// Exact solvers for test oracles (the port's copy of
// pymht_tpu/native/exact_solver.cpp: the code below the header comment
// is the same, line for line).
//
// 1) solve_ilp_exact: best-first branch-and-bound for the MHT
//    hypothesis-selection 0/1 program
//        min f.tau   s.t. one tau per target group, each measurement
//        row used at most once
//    a compact exact solver for validating the optimality gap of the
//    on-device LP and Lagrangian selections.
//
// 2) solve_lap_jv: Jonker-Volgenant O(n^3) linear assignment for
//    validating the auction GNN.
//
// C ABI for ctypes.  Built at first use by
// pymht_tpu_torch/kernels/build.py (host C++ compiler, -O3 -std=c++17).
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

struct Node {
  double bound;
  int depth;                  // next target to fix
  std::vector<int> choice;    // chosen leaf per fixed target
  std::vector<uint8_t> used;  // measurement-row usage
  bool operator<(const Node& o) const { return bound > o.bound; }
};

// Per-target sorted leaf order by cost helps the bound.
double greedy_bound(int t_from, int n_targets, int L, const double* f,
                    const int32_t* rows, const int32_t* row_ptr,
                    const std::vector<uint8_t>& used) {
  // Sum over remaining targets of their cheapest *individually feasible*
  // leaf (ignoring interactions) — an admissible lower bound.
  double b = 0.0;
  for (int t = t_from; t < n_targets; ++t) {
    double best = std::numeric_limits<double>::infinity();
    for (int l = 0; l < L; ++l) {
      int j = t * L + l;
      double c = f[j];
      if (c >= 1e8) continue;  // masked
      bool ok = true;
      for (int k = row_ptr[j]; k < row_ptr[j + 1]; ++k)
        if (used[rows[k]]) { ok = false; break; }
      // A leaf conflicting with *current* usage may still be usable in
      // a different combination of earlier choices; for a valid lower
      // bound we must NOT exclude it based on usage. Use min over all.
      (void)ok;
      if (c < best) best = c;
    }
    if (best == std::numeric_limits<double>::infinity()) best = 0.0;
    b += best;
  }
  return b;
}

}  // namespace

extern "C" {

// f: [n_targets*L] costs (>=1e8 == masked leaf)
// rows / row_ptr: CSR of measurement-row ids used by each leaf
// n_rows: number of single-use rows
// out_sel: [n_targets] chosen leaf per target
// returns objective; sets *optimal=1 if proven optimal within node budget
double solve_ilp_exact(int n_targets, int L, int n_rows, const double* f,
                       const int32_t* rows, const int32_t* row_ptr,
                       int64_t max_nodes, int32_t* out_sel,
                       int32_t* optimal) {
  std::priority_queue<Node> pq;
  Node root;
  root.depth = 0;
  root.used.assign(n_rows, 0);
  root.bound = greedy_bound(0, n_targets, L, f, rows, row_ptr, root.used);
  pq.push(std::move(root));

  double incumbent = std::numeric_limits<double>::infinity();
  std::vector<int> best_choice;
  int64_t nodes = 0;
  bool exhausted = true;

  while (!pq.empty()) {
    if (++nodes > max_nodes) { exhausted = false; break; }
    Node cur = pq.top();
    pq.pop();
    if (cur.bound >= incumbent - 1e-9) continue;
    if (cur.depth == n_targets) {
      double obj = 0.0;
      for (int t = 0; t < n_targets; ++t) obj += f[t * L + cur.choice[t]];
      if (obj < incumbent) { incumbent = obj; best_choice = cur.choice; }
      continue;
    }
    int t = cur.depth;
    for (int l = 0; l < L; ++l) {
      int j = t * L + l;
      if (f[j] >= 1e8) continue;
      bool ok = true;
      for (int k = row_ptr[j]; k < row_ptr[j + 1]; ++k)
        if (cur.used[rows[k]]) { ok = false; break; }
      if (!ok) continue;
      Node child;
      child.depth = t + 1;
      child.choice = cur.choice;
      child.choice.push_back(l);
      child.used = cur.used;
      for (int k = row_ptr[j]; k < row_ptr[j + 1]; ++k)
        child.used[rows[k]] = 1;
      double fixed = 0.0;
      for (int tt = 0; tt < child.depth; ++tt)
        fixed += f[tt * L + child.choice[tt]];
      child.bound = fixed + greedy_bound(child.depth, n_targets, L, f,
                                         rows, row_ptr, child.used);
      if (child.bound < incumbent - 1e-9) pq.push(std::move(child));
    }
  }

  if (best_choice.empty()) {
    // No feasible completion found (should not happen when each target
    // has an unconstrained leaf); fall back to per-target argmin.
    best_choice.assign(n_targets, 0);
    for (int t = 0; t < n_targets; ++t) {
      double best = std::numeric_limits<double>::infinity();
      for (int l = 0; l < L; ++l)
        if (f[t * L + l] < best) { best = f[t * L + l]; best_choice[t] = l; }
    }
    incumbent = 0.0;
    for (int t = 0; t < n_targets; ++t)
      incumbent += f[t * L + best_choice[t]];
    exhausted = false;
  }
  for (int t = 0; t < n_targets; ++t) out_sel[t] = best_choice[t];
  *optimal = exhausted ? 1 : 0;
  return incumbent;
}

// Jonker-Volgenant shortest-augmenting-path LAP.
// cost: [n*n] row-major (use big values for forbidden).  out_col[i] =
// column assigned to row i.  Returns total cost.
double solve_lap_jv(int n, const double* cost, int32_t* out_col) {
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
  std::vector<int> p(n + 1, 0), way(n + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(n + 1, INF);
    std::vector<char> used(n + 1, false);
    do {
      used[j0] = true;
      int i0 = p[j0], j1 = -1;
      double delta = INF;
      for (int j = 1; j <= n; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
        if (minv[j] < delta) { delta = minv[j]; j1 = j; }
      }
      for (int j = 0; j <= n; ++j) {
        if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
        else minv[j] -= delta;
      }
      j0 = j1;
    } while (p[j0] != 0);
    do { int j1 = way[j0]; p[j0] = p[j1]; j0 = j1; } while (j0);
  }
  double total = 0.0;
  for (int j = 1; j <= n; ++j) {
    if (p[j] > 0) {
      out_col[p[j] - 1] = j - 1;
      total += cost[(p[j] - 1) * n + (j - 1)];
    }
  }
  return total;
}

}  // extern "C"
