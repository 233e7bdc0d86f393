// Exact linear-assignment (Hungarian, shortest augmenting paths with
// potentials, O(n^3)) — the native counterpart of the reference's
// scipy.optimize.linear_sum_assignment host dependency
// (reference segmentation/mmseg_custom/models/utils/assigner.py:41).
//
// Built as a shared library and bound via ctypes (no pybind11 in the image).
// Supports rectangular problems (rows >= cols or cols >= rows) by padding
// internally. Batched entry point releases no GIL concerns (pure C).

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Square Hungarian on an n x n cost matrix (row-major). Fills row2col.
void solve_square(int n, const double* cost, int* row2col) {
  // 1-indexed potentials / matching per the classic formulation.
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0), minv(n + 1);
  std::vector<int> p(n + 1, 0), way(n + 1, 0);
  std::vector<char> used(n + 1);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::fill(minv.begin(), minv.end(), kInf);
    std::fill(used.begin(), used.end(), 0);
    do {
      used[j0] = 1;
      const int i0 = p[j0];
      double delta = kInf;
      int j1 = -1;
      const double* row = cost + (int64_t)(i0 - 1) * n;
      for (int j = 1; j <= n; ++j) {
        if (used[j]) continue;
        const double cur = row[j - 1] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= n; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      const int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int j = 1; j <= n; ++j) {
    if (p[j] >= 1) row2col[p[j] - 1] = j - 1;
  }
}

}  // namespace

extern "C" {

// cost: (rows, cols) row-major. row2col: (rows,) output, -1 = unassigned.
// Rectangular problems are padded to square with a cost above any real
// entry so real assignments are always preferred.
void lap_solve(int rows, int cols, const double* cost, int* row2col) {
  const int n = rows > cols ? rows : cols;
  double maxc = 0.0;
  for (int64_t k = 0; k < (int64_t)rows * cols; ++k) {
    const double a = cost[k] < 0 ? -cost[k] : cost[k];
    if (a > maxc) maxc = a;
  }
  const double pad = maxc * 2.0 + 1.0;
  std::vector<double> sq((int64_t)n * n, pad);
  for (int i = 0; i < rows; ++i)
    std::memcpy(sq.data() + (int64_t)i * n, cost + (int64_t)i * cols,
                sizeof(double) * cols);
  std::vector<int> r2c(n, -1);
  solve_square(n, sq.data(), r2c.data());
  for (int i = 0; i < rows; ++i)
    row2col[i] = (r2c[i] < cols) ? r2c[i] : -1;
}

// Batched: costs (batch, rows, cols); n_valid_cols per item; out (batch, rows).
void lap_solve_batch(int batch, int rows, int cols, const double* costs,
                     const int* n_valid_cols, int* row2col) {
  std::vector<double> sub;
  for (int b = 0; b < batch; ++b) {
    const int nv = n_valid_cols[b] < cols ? n_valid_cols[b] : cols;
    int* out = row2col + (int64_t)b * rows;
    for (int i = 0; i < rows; ++i) out[i] = -1;
    if (nv <= 0) continue;
    sub.resize((int64_t)rows * nv);
    const double* base = costs + (int64_t)b * rows * cols;
    for (int i = 0; i < rows; ++i)
      std::memcpy(sub.data() + (int64_t)i * nv, base + (int64_t)i * cols,
                  sizeof(double) * nv);
    lap_solve(rows, nv, sub.data(), out);
  }
}

}  // extern "C"
