// Exact Ising ground states by branch-and-bound enumeration.
//
// E(s) = c0 + 1/2 ||M s||^2 exactly, with M = diag(sqrt(lmax - eig)) V^T
// (the Python side builds M and its QR factor R; see nmc_tpu/exact.py
// solve_exact_enum). For upper-triangular R and z enumerated from the
// last coordinate, rows i..n-1 of R z are fully determined once
// z_i..z_{n-1} are fixed, so the accumulated squared norm is an exact
// lower bound on ||R z||^2 — Fincke-Pohst enumeration over the +-1 cube,
// with two sharpenings:
//   * incremental prefix sums f[k] = sum_{j fixed} R[k,j] z_j for the
//     not-yet-determined rows (O(depth) update per node), and
//   * a box bound on every remaining row: row k < i can contribute at
//     least max(0, |f_k| - sum_{j=k..i-1} |R[k,j]|)^2,
//     fused into the same pass as the prefix update.
// The search proves optimality: if it completes without improving the
// initial radius, the incumbent is the exact ground state.
//
// Two precisions: double, and a float variant (2x SIMD width) for
// integer-valued energy landscapes where the radius carries a quantum of
// slack far above f32 rounding (the Python caller checks this).
//
// `progress` (optional): written with the node count every ~16M nodes so
// a watcher thread can report liveness on multi-hour proofs.
//
// Built by nmc_tpu/native/__init__.py with g++ -O3 at first use; plain C
// ABI via ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

template <typename T>
long long enumerate_impl(int n, const T* R, const T* W, double* best_r2_io,
                         double* best_z, int* found, int* status,
                         long long max_nodes,
                         volatile long long* progress) {
  std::vector<T> f(n, T(0));
  std::vector<T> z(n, T(0));
  std::vector<T> acc(n + 1, T(0));
  std::vector<int> branch(n, 0);
  std::vector<T> first(n, T(0));
  T best_r2 = T(*best_r2_io);

  *found = 0;
  *status = 0;
  long long nodes = 0;

  int i = n - 1;
  z[i] = T(1);                        // global spin-flip symmetry
  {
    T r = R[i * n + i];
    acc[i] = r * r;
    const T* col = R + i;             // column i, stride n
    for (int k = 0; k < i; ++k) f[k] += col[k * n];
  }
  if (!(acc[i] < best_r2)) return 1;
  --i;
  branch[i] = 0;

  while (i < n - 1) {
    if (branch[i] >= 2) {
      ++i;
      if (i >= n - 1) break;
      T zi = z[i];
      const T* col = R + i;
      for (int k = 0; k < i; ++k) f[k] -= col[k * n] * zi;
      ++branch[i];
      continue;
    }
    if (branch[i] == 0) {
      T t = f[i];
      T d = R[i * n + i];
      first[i] = (std::fabs(d + t) <= std::fabs(-d + t)) ? T(1) : T(-1);
    }
    T zi = branch[i] == 0 ? first[i] : -first[i];
    ++nodes;
    if ((nodes & 0xFFFFFF) == 0 && progress) *progress = nodes;
    if (max_nodes > 0 && nodes > max_nodes) { *status = 1; break; }

    T r = R[i * n + i] * zi + f[i];
    T a2 = acc[i + 1] + r * r;
    if (!(a2 < best_r2)) { ++branch[i]; continue; }

    if (i == 0) {
      z[0] = zi;
      best_r2 = a2;
      *found = 1;
      for (int k = 0; k < n; ++k) best_z[k] = double(z[k]);
      ++branch[i];
      continue;
    }

    // descend: one fused pass updates prefix sums AND evaluates the
    // box bound over the remaining rows
    {
      T lb = a2;
      const T* col = R + i;
      const T* Wcol = W + i;
      bool prune = false;
      for (int k = 0; k < i; ++k) {
        T fk = f[k] + col[k * n] * zi;
        f[k] = fk;
        T slack = std::fabs(fk) - Wcol[k * n];
        if (slack > T(0)) {
          lb += slack * slack;
          if (!(lb < best_r2)) { prune = true; /* finish updates */ }
        }
      }
      if (prune) {
        // undo the prefix updates and take the other branch
        for (int k = 0; k < i; ++k) f[k] -= col[k * n] * zi;
        ++branch[i];
        continue;
      }
    }
    z[i] = zi;
    acc[i] = a2;
    --i;
    branch[i] = 0;
  }
  *best_r2_io = double(best_r2);
  if (progress) *progress = nodes;
  return nodes;
}

}  // namespace

extern "C" {

long long nmc_exact_enumerate(
    int n, const double* R, const double* W, double* best_r2,
    double* best_z, int* found, int* status, long long max_nodes,
    volatile long long* progress) {
  return enumerate_impl<double>(n, R, W, best_r2, best_z, found, status,
                                max_nodes, progress);
}

long long nmc_exact_enumerate_f32(
    int n, const float* R, const float* W, double* best_r2,
    double* best_z, int* found, int* status, long long max_nodes,
    volatile long long* progress) {
  return enumerate_impl<float>(n, R, W, best_r2, best_z, found, status,
                               max_nodes, progress);
}

}  // extern "C"
