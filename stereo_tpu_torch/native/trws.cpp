// The serial TRW-S of the stereo_tpu_torch port: a copy of
// stereo_tpu/native/trws.cpp (the port keeps its own, built by
// stereo_tpu_torch/native/__init__.py into a library of its own),
// called by solvers/trws_host.py.
//
// Serial TRW-S with the stereo continuous-position potential family — the
// trws_mex/MRFEnergy equivalent of the native runtime, written from
// Kolmogorov's TRW-S paper and the lower-envelope distance-transform idea of
// Felzenszwalb & Huttenlocher (generalized to non-uniform positions, as the
// papers' O(K) message update does; cf. typeStereoLinear.h:329-487 for the
// reference's behavior).  Flat arrays, caller-supplied node ordering, no
// pooled allocators or linked node lists.
//
// Potential of directed edge e = (tail -> head):
//   V(k_t, k_h) = alpha_e * min(|q_src[e][k_t] - q_dst[e][k_h]|^kernel, tol)
// Message update from `src` side with gamma-scaled beliefs H:
//   msg[k'] = min_k ( H[k] + V(...) ), then normalized by its min.
// Computed in O(K) per edge via the lower envelope of cones (kernel 1) or
// parabolas (kernel 2) anchored at sorted source positions, evaluated at
// sorted destination positions, truncated at min(H) + alpha * tol.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct EdgeSide {
  // positions and their ascending sort order for one side of an edge
  const double* pos;     // K values
  const int32_t* order;  // K indices, pos[order[0]] smallest
};

// Lower-envelope min-sum transform for truncated-linear cost:
// out[j] = min( minH + alpha*tol, min_i( H[i] + alpha*|src[i] - dst[j]| ) ).
void dt_linear(int K, const double* H, const double* src, const int32_t* sord,
               const double* dst, const int32_t* dord, double alpha,
               double tol, double* out, std::vector<int32_t>& v,
               std::vector<double>& z) {
  double minH = kInf;
  for (int k = 0; k < K; k++) minH = std::min(minH, H[k]);
  if (alpha <= 0) {
    for (int k = 0; k < K; k++) out[k] = minH;
    return;
  }
  const double cap = minH + alpha * tol;

  // build the lower envelope of V-cones anchored at (src[i], H[i]),
  // scanning anchors in ascending position order; z holds the region
  // boundaries, the last one always +inf.  The JAX package's copy kept the
  // previous cone on a tie (hk + dist == hj, where the new cone is as low
  // everywhere and lower right of qj) and when the crossing rounded onto
  // qj, so the new cone never entered: messages too high and a lower bound
  // above the optimum; after such a pop a later break also left z's last
  // boundary finite, and the evaluation read past its end.
  v.clear();
  z.clear();
  v.push_back(sord[0]);
  z.push_back(-kInf);
  z.push_back(kInf);
  for (int n = 1; n < K; n++) {
    int k = sord[n];
    double hk = H[k], qk = src[k];
    while (!v.empty()) {
      int j = v.back();
      double hj = H[j], qj = src[j];  // qj <= qk
      double dist = alpha * (qk - qj);
      if (hj + dist <= hk) break;  // new cone never below the previous one
      // cones cross at s: hj + alpha(s - qj) = hk - alpha(s - qk)
      double s = ((hk - hj) + alpha * (qk + qj)) / (2.0 * alpha);
      if (hk + dist <= hj || s <= qj) {
        // new cone nowhere above the previous anchor's (ties included, and
        // a crossing rounded onto qj): the previous anchor leaves
        v.pop_back();
        z.pop_back();
        z.back() = kInf;
        continue;
      }
      v.push_back(k);
      z.back() = s;
      z.push_back(kInf);
      break;
    }
    if (v.empty()) {
      v.push_back(k);
      z.assign({-kInf, kInf});
    }
  }

  // evaluate at destinations in ascending order
  size_t j = 0;
  for (int n = 0; n < K; n++) {
    int k = dord[n];
    double x = dst[k];
    while (z[j + 1] < x) j++;
    int a = v[j];
    out[k] = std::min(cap, H[a] + alpha * std::abs(x - src[a]));
  }
}

// Same for truncated-quadratic cost (parabola envelope; F-H distance
// transform generalized to non-uniform positions).
void dt_quadratic(int K, const double* H, const double* src,
                  const int32_t* sord, const double* dst, const int32_t* dord,
                  double alpha, double tol, double* out,
                  std::vector<int32_t>& v, std::vector<double>& z) {
  double minH = kInf;
  for (int k = 0; k < K; k++) minH = std::min(minH, H[k]);
  if (alpha <= 0) {
    for (int k = 0; k < K; k++) out[k] = minH;
    return;
  }
  const double cap = minH + alpha * tol;

  v.clear();
  z.clear();
  v.push_back(sord[0]);
  z.push_back(-kInf);
  z.push_back(kInf);
  for (int n = 1; n < K; n++) {
    int k = sord[n];
    double hk = H[k], qk = src[k];
    while (true) {
      int j = v.back();
      double hj = H[j], qj = src[j];
      if (qk - qj < 1e-12) {
        // coincident anchors: keep the lower parabola (ref :421-446)
        if (hk >= hj) break;
        v.pop_back();
        z.pop_back();
        if (v.empty()) {
          v.push_back(k);
          z.back() = -kInf;
          z.push_back(kInf);
          break;
        }
        continue;
      }
      double s = ((hk + alpha * qk * qk) - (hj + alpha * qj * qj)) /
                 (2.0 * alpha * (qk - qj));
      if (s <= z[z.size() - 2]) {
        v.pop_back();
        z.pop_back();
        if (v.empty()) {
          v.push_back(k);
          z.back() = -kInf;
          z.push_back(kInf);
          break;
        }
        continue;
      }
      v.push_back(k);
      z.back() = s;
      z.push_back(kInf);
      break;
    }
  }

  size_t j = 0;
  for (int n = 0; n < K; n++) {
    int k = dord[n];
    double x = dst[k];
    while (z[j + 1] < x) j++;
    int a = v[j];
    double d = x - src[a];
    out[k] = std::min(cap, H[a] + alpha * d * d);
  }
}

}  // namespace

extern "C" {

// Serial TRW-S.  unary: node-major K*N; q_src/q_dst: edge-major K*E;
// order: permutation of 0..N-1 (processing order).  Outputs: labels (N),
// energy, lower bound; returns iterations run.  trace_e/trace_lb/trace_t
// (nullable, length >= maxiter) record the decoded energy, lower bound and
// cumulative wall-clock seconds after each iteration — the benchmark's
// time-to-energy trajectory.
int trws_serial(int kernel, int K, int n_nodes, int n_edges,
                const double* unary, const int32_t* tails,
                const int32_t* heads, const double* q_src,
                const double* q_dst, const double* alphas, double tol,
                const int32_t* order, int maxiter, double max_relgap,
                int32_t* labels_out, double* energy_out, double* lb_out,
                double* trace_e, double* trace_lb, double* trace_t) {
  auto t_start = std::chrono::steady_clock::now();
  std::vector<int32_t> pos(n_nodes);
  for (int r = 0; r < n_nodes; r++) pos[order[r]] = r;

  // per-edge sorted index tables
  std::vector<int32_t> sords((size_t)K * n_edges), dords((size_t)K * n_edges);
  for (int e = 0; e < n_edges; e++) {
    int32_t* so = &sords[(size_t)K * e];
    int32_t* do_ = &dords[(size_t)K * e];
    std::iota(so, so + K, 0);
    std::iota(do_, do_ + K, 0);
    const double* qs = &q_src[(size_t)K * e];
    const double* qd = &q_dst[(size_t)K * e];
    std::sort(so, so + K, [&](int a, int b) { return qs[a] < qs[b]; });
    std::sort(do_, do_ + K, [&](int a, int b) { return qd[a] < qd[b]; });
  }

  // incident edges per node
  std::vector<std::vector<int32_t>> inc(n_nodes);
  for (int e = 0; e < n_edges; e++) {
    inc[tails[e]].push_back(e);
    inc[heads[e]].push_back(e);
  }

  // gammas = 1 / max(nFwd, nBwd) (treeProbabilities.cpp:12-47)
  std::vector<double> gamma(n_nodes);
  for (int i = 0; i < n_nodes; i++) {
    int nf = 0;
    for (int e : inc[i]) {
      int other = tails[e] == i ? heads[e] : tails[e];
      if (pos[other] > pos[i]) nf++;
    }
    int nb = (int)inc[i].size() - nf;
    gamma[i] = 1.0 / std::max(std::max(nf, nb), 1);
  }

  std::vector<double> msg((size_t)K * n_edges, 0.0);
  std::vector<double> D(K), Hbuf(K);
  std::vector<int32_t> venv;
  std::vector<double> zenv;
  venv.reserve(K + 1);
  zenv.reserve(K + 2);

  auto beliefs = [&](int i, double* out) {
    const double* u = &unary[(size_t)K * i];
    for (int k = 0; k < K; k++) out[k] = u[k];
    for (int e : inc[i])
      for (int k = 0; k < K; k++) out[k] += msg[(size_t)K * e + k];
  };

  auto send = [&](int e, int src_node, const double* Dsrc) -> double {
    // H = gamma*D - msg; transform toward the other endpoint
    double* m = &msg[(size_t)K * e];
    const double* qs = &q_src[(size_t)K * e];
    const double* qd = &q_dst[(size_t)K * e];
    const int32_t* so = &sords[(size_t)K * e];
    const int32_t* do_ = &dords[(size_t)K * e];
    for (int k = 0; k < K; k++)
      Hbuf[k] = gamma[src_node] * Dsrc[k] - m[k];
    if (src_node == tails[e]) {
      // envelope over source positions q_src, evaluated at q_dst
      if (kernel == 1)
        dt_linear(K, Hbuf.data(), qs, so, qd, do_, alphas[e], tol, m, venv, zenv);
      else
        dt_quadratic(K, Hbuf.data(), qs, so, qd, do_, alphas[e], tol, m, venv, zenv);
    } else {
      if (kernel == 1)
        dt_linear(K, Hbuf.data(), qd, do_, qs, so, alphas[e], tol, m, venv, zenv);
      else
        dt_quadratic(K, Hbuf.data(), qd, do_, qs, so, alphas[e], tol, m, venv, zenv);
    }
    double vmin = kInf;
    for (int k = 0; k < K; k++) vmin = std::min(vmin, m[k]);
    for (int k = 0; k < K; k++) m[k] -= vmin;
    return vmin;
  };

  auto edge_cost = [&](int e, int kt, int kh) {
    double d = q_src[(size_t)K * e + kt] - q_dst[(size_t)K * e + kh];
    double c = kernel == 1 ? std::abs(d) : d * d;
    return alphas[e] * std::min(c, tol);
  };

  double energy = 0.0, lb = 0.0;
  int iter = 0;
  for (iter = 1; iter <= maxiter; iter++) {
    // forward pass
    for (int r = 0; r < n_nodes; r++) {
      int i = order[r];
      beliefs(i, D.data());
      for (int e : inc[i]) {
        int other = tails[e] == i ? heads[e] : tails[e];
        if (pos[other] > pos[i]) send(e, i, D.data());
      }
    }
    // backward pass with lower bound
    lb = 0.0;
    for (int r = n_nodes - 1; r >= 0; r--) {
      int i = order[r];
      beliefs(i, D.data());
      double vmin = kInf;
      for (int k = 0; k < K; k++) vmin = std::min(vmin, D[k]);
      for (int k = 0; k < K; k++) D[k] -= vmin;
      lb += vmin;
      for (int e : inc[i]) {
        int other = tails[e] == i ? heads[e] : tails[e];
        if (pos[other] < pos[i]) lb += send(e, i, D.data());
      }
    }
    // decode (ComputeSolutionAndEnergy, minimize.cpp:223-264)
    energy = 0.0;
    for (int r = 0; r < n_nodes; r++) {
      int i = order[r];
      const double* u = &unary[(size_t)K * i];
      for (int k = 0; k < K; k++) D[k] = u[k];
      for (int e : inc[i]) {
        int other = tails[e] == i ? heads[e] : tails[e];
        if (pos[other] < pos[i]) {
          int ko = labels_out[other];
          for (int k = 0; k < K; k++)
            D[k] += tails[e] == i ? edge_cost(e, k, ko) : edge_cost(e, ko, k);
        }
      }
      // Dbackward value saved before forward messages
      std::vector<double>& Db = Hbuf;
      for (int k = 0; k < K; k++) Db[k] = D[k];
      for (int e : inc[i]) {
        int other = tails[e] == i ? heads[e] : tails[e];
        if (pos[other] > pos[i])
          for (int k = 0; k < K; k++) D[k] += msg[(size_t)K * e + k];
      }
      int best = 0;
      for (int k = 1; k < K; k++)
        if (D[k] < D[best]) best = k;
      labels_out[i] = best;
      energy += Db[best];
    }
    if (trace_e) trace_e[iter - 1] = energy;
    if (trace_lb) trace_lb[iter - 1] = lb;
    if (trace_t)
      trace_t[iter - 1] =
          std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                        t_start)
              .count();
    double relgap = energy != 0 ? (energy - lb) / energy : 0.0;
    if (relgap < max_relgap) break;
  }
  *energy_out = energy;
  *lb_out = lb;
  return std::min(iter, maxiter);
}

}  // extern "C"
