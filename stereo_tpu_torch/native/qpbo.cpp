// The QPBO (roof duality) solver of the stereo_tpu_torch port: a copy of
// stereo_tpu/native/qpbo.cpp (the port keeps its own, built by
// stereo_tpu_torch/native/__init__.py into a library of its own),
// called by solvers/qpbo_host.py.
//
// QPBO (roof duality) solver — the rd_mex/QPBO-v1.3 equivalent, written from
// the published construction (Boros & Hammer's roof duality; Kolmogorov &
// Rother, "Minimizing Nonsubmodular Functions with Graph Cuts — A Review",
// PAMI 2007).  Not a port: flat arc arrays + deque work lists instead of the
// reference's pointer-linked node/arc structs and pooled allocators, and a
// from-scratch symmetric doubled-graph builder.
//
// Maxflow engine: the Boykov–Kolmogorov augmenting-path algorithm ("An
// Experimental Comparison of Min-Cut/Max-Flow Algorithms for Energy
// Minimization in Vision", PAMI 2004) — two search trees grown from the
// terminals with orphan adoption and timestamp/distance reuse.  This is the
// algorithm family the reference uses (QPBO_maxflow.cpp), implemented fresh:
// terminal capacities live in a signed per-node excess array (no explicit
// s/t nodes), arcs are paired ids (rev = id ^ 1), and the grow/augment/adopt
// phases are explicit loops over those ids.
//
// Construction.  Variables x_i in {0,1}; the network has nodes u_i ("x_i")
// and v_i ("~x_i").  Convention: a node on the SINK side of the cut means
// its literal is 1.  Every energy term contributes half its weight to the
// u-side and half, mirrored, to the v-side, which keeps the network
// symmetric under (u_i <-> v_i, arc reversal) — the property roof duality
// needs.
//   unary  w*x_i   (w>=0):  s->u_i w/2,  v_i->t w/2
//          w*x_i   (w<0):   u_i->t -w/2, s->v_i -w/2, const += w
//   pairwise (a,b,c,d) = th(00),th(01),th(10),th(11):
//      B = b + c - a - d  (>= 0 iff submodular)
//      submodular:   th = a + (c-a)x_i + (d-c)x_j + B(1-x_i)x_j
//                    -> arcs u_i->u_j B/2, v_j->v_i B/2 + linear terms
//      supermodular: substitute z_j = ~x_j (table becomes submodular with
//                    B' = -B) -> arcs u_i->v_j B'/2, u_j->v_i B'/2
//                    (z_j's node IS v_j), linear terms rewritten in x_j.
// Lower bound = const + maxflow (the roof dual).  Strong persistency: after
// the cut, x_i is labeled iff u_i and v_i end on opposite sides of the
// residual reachability split.  Labeling all such nodes (others keep any
// value) never increases the energy (autarky) — the property binary fusion
// relies on (rd_mex.cpp:55-100, dispmap_super.m:83).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr double EPS = 1e-12;

struct BKMaxflow {
  struct Arc {
    int32_t to;
    double cap;
  };
  int n;
  // arc ids come in pairs: rev(a) == a ^ 1
  std::vector<Arc> arcs;
  std::vector<int32_t> next_arc;   // per arc: next arc out of the same node
  std::vector<int32_t> first_arc;  // per node: head of its arc list (-1)
  std::vector<double> tcap;        // signed terminal excess: >0 s->v, <0 v->t

  // search-tree state
  enum : uint8_t { FREE = 0, SRC = 1, SNK = 2 };
  enum : int32_t { NONE = -2, TERMINAL = -1 };
  std::vector<uint8_t> tree;
  std::vector<int32_t> parent;  // arc id FROM v TO its parent, or sentinel
  std::vector<int32_t> ts;      // timestamp of dist validity
  std::vector<int32_t> dist;    // distance to the tree's terminal
  std::deque<int32_t> active;
  std::deque<int32_t> orphans;
  int32_t time_now = 0;
  double flow = 0.0;

  explicit BKMaxflow(int n_)
      : n(n_), first_arc(n_, -1), tcap(n_, 0.0), tree(n_, FREE),
        parent(n_, NONE), ts(n_, 0), dist(n_, 0) {}

  void add_arc(int from, int to, double cap, double rcap = 0.0) {
    if (cap <= 0 && rcap <= 0) return;
    int32_t a = (int32_t)arcs.size();
    arcs.push_back({(int32_t)to, cap});
    arcs.push_back({(int32_t)from, rcap});
    next_arc.push_back(first_arc[from]);
    next_arc.push_back(first_arc[to]);
    first_arc[from] = a;
    first_arc[to] = a + 1;
  }

  void add_tweights(int v, double cap_s, double cap_t) {
    double f = std::min(cap_s, cap_t);
    if (f > 0) flow += f;
    tcap[v] += cap_s - cap_t;
  }

  // residual capacity of the arc connecting v to its parent, in the
  // direction flow would take through v's tree
  double parent_res(int v) const {
    int32_t pa = parent[v];
    // SRC tree: flow runs parent -> v, i.e. along rev(pa)
    // SNK tree: flow runs v -> parent, i.e. along pa
    return tree[v] == SRC ? arcs[pa ^ 1].cap : arcs[pa].cap;
  }

  // Walk v to its root; true iff the root hangs off a terminal.  Refreshes
  // dist/ts along the way (the BK origin-check heuristic).
  bool has_valid_origin(int v) {
    int32_t d = 0;
    int u = v;
    while (true) {
      if (ts[u] == time_now) {
        d += dist[u];
        break;
      }
      int32_t pa = parent[u];
      if (pa == TERMINAL) {
        d += 1;
        break;
      }
      if (pa == NONE) return false;
      u = arcs[pa].to;
      d += 1;
    }
    // second pass: stamp distances
    int32_t rem = d;
    u = v;
    while (ts[u] != time_now) {
      ts[u] = time_now;
      dist[u] = rem--;
      int32_t pa = parent[u];
      if (pa == TERMINAL) break;
      u = arcs[pa].to;
    }
    return true;
  }

  void augment(int32_t join_arc) {
    // join_arc runs from an SRC-tree node p to a SNK-tree node q
    int p = arcs[join_arc ^ 1].to;
    int q = arcs[join_arc].to;
    double bottleneck = arcs[join_arc].cap;
    for (int v = p; parent[v] != TERMINAL; v = arcs[parent[v]].to)
      bottleneck = std::min(bottleneck, arcs[parent[v] ^ 1].cap);
    {
      int root = p;
      while (parent[root] != TERMINAL) root = arcs[parent[root]].to;
      bottleneck = std::min(bottleneck, tcap[root]);
    }
    for (int v = q; parent[v] != TERMINAL; v = arcs[parent[v]].to)
      bottleneck = std::min(bottleneck, arcs[parent[v]].cap);
    {
      int root = q;
      while (parent[root] != TERMINAL) root = arcs[parent[root]].to;
      bottleneck = std::min(bottleneck, -tcap[root]);
    }

    arcs[join_arc].cap -= bottleneck;
    arcs[join_arc ^ 1].cap += bottleneck;
    // source side: saturating the parent->v arc orphans v
    for (int v = p;;) {
      int32_t pa = parent[v];
      if (pa == TERMINAL) {
        tcap[v] -= bottleneck;
        if (tcap[v] <= EPS) {
          parent[v] = NONE;
          orphans.push_back(v);
        }
        break;
      }
      arcs[pa ^ 1].cap -= bottleneck;
      arcs[pa].cap += bottleneck;
      int u = arcs[pa].to;
      if (arcs[pa ^ 1].cap <= EPS) {
        parent[v] = NONE;
        orphans.push_back(v);
      }
      v = u;
    }
    // sink side
    for (int v = q;;) {
      int32_t pa = parent[v];
      if (pa == TERMINAL) {
        tcap[v] += bottleneck;
        if (-tcap[v] <= EPS) {
          parent[v] = NONE;
          orphans.push_back(v);
        }
        break;
      }
      arcs[pa].cap -= bottleneck;
      arcs[pa ^ 1].cap += bottleneck;
      int u = arcs[pa].to;
      if (arcs[pa].cap <= EPS) {
        parent[v] = NONE;
        orphans.push_back(v);
      }
      v = u;
    }
    flow += bottleneck;
  }

  void adopt() {
    while (!orphans.empty()) {
      int v = orphans.front();
      orphans.pop_front();
      uint8_t tr = tree[v];
      // find a new parent: same tree, residual arc toward v's terminal
      // direction, valid origin; prefer the closest (smallest dist)
      int32_t best = NONE;
      int32_t best_d = INT32_MAX;
      for (int32_t a = first_arc[v]; a >= 0; a = next_arc[a]) {
        int u = arcs[a].to;
        if (tree[u] != tr) continue;
        double res = tr == SRC ? arcs[a ^ 1].cap : arcs[a].cap;
        if (res <= EPS) continue;
        if (!has_valid_origin(u)) continue;
        if (dist[u] < best_d) {
          best_d = dist[u];
          best = a;
        }
      }
      if (best != NONE) {
        parent[v] = best;
        ts[v] = time_now;
        dist[v] = best_d + 1;
        continue;
      }
      // no parent: v leaves the tree; children become orphans, neighbors
      // that could re-adopt or re-grow become active
      for (int32_t a = first_arc[v]; a >= 0; a = next_arc[a]) {
        int u = arcs[a].to;
        if (tree[u] != tr) continue;
        if (parent[u] >= 0 && arcs[parent[u]].to == v) {
          parent[u] = NONE;
          orphans.push_back(u);
        }
        double res = tr == SRC ? arcs[a ^ 1].cap : arcs[a].cap;
        if (res > EPS) active.push_back(u);
      }
      tree[v] = FREE;
      parent[v] = NONE;
    }
  }

  double run() {
    for (int v = 0; v < n; v++) {
      if (tcap[v] > EPS) {
        tree[v] = SRC;
        parent[v] = TERMINAL;
        active.push_back(v);
      } else if (tcap[v] < -EPS) {
        tree[v] = SNK;
        parent[v] = TERMINAL;
        active.push_back(v);
      }
    }
    time_now = 1;
    while (!active.empty()) {
      int p = active.front();
      active.pop_front();
      if (tree[p] == FREE) continue;
      uint8_t tr = tree[p];
      bool reactivate = false;
      for (int32_t a = first_arc[p]; a >= 0; a = next_arc[a]) {
        double res = tr == SRC ? arcs[a].cap : arcs[a ^ 1].cap;
        if (res <= EPS) continue;
        int q = arcs[a].to;
        if (tree[q] == FREE) {
          tree[q] = tr;
          parent[q] = a ^ 1;  // arc from q back to p
          ts[q] = ts[p];
          dist[q] = dist[p] + 1;
          active.push_back(q);
        } else if (tree[q] != tr) {
          // augmenting path found through a (SRC->SNK direction)
          int32_t join = tr == SRC ? a : (a ^ 1);
          augment(join);
          time_now++;
          adopt();
          if (tree[p] != tr) break;  // p fell out of its tree
          reactivate = true;         // rescan p's arcs next round
          break;
        } else if (ts[q] <= ts[p] && dist[q] > dist[p] + 1) {
          // heuristic: steal q onto a shorter path
          parent[q] = a ^ 1;
          ts[q] = ts[p];
          dist[q] = dist[p] + 1;
        }
      }
      if (reactivate) active.push_back(p);
    }
    return flow;
  }

  // nodes reachable from the source through residual arcs
  void source_reachable(std::vector<uint8_t>& mark) const {
    mark.assign(n, 0);
    std::vector<int> stack;
    for (int v = 0; v < n; v++)
      if (tcap[v] > EPS) {
        mark[v] = 1;
        stack.push_back(v);
      }
    while (!stack.empty()) {
      int v = stack.back();
      stack.pop_back();
      for (int32_t a = first_arc[v]; a >= 0; a = next_arc[a]) {
        if (arcs[a].cap > EPS && !mark[arcs[a].to]) {
          mark[arcs[a].to] = 1;
          stack.push_back(arcs[a].to);
        }
      }
    }
  }
};

// Iterative Tarjan SCC over the residual graph restricted to a node subset.
// comp[v] = component id in *finalization order* (an SCC is numbered only
// once all its successors are numbered, so every residual arc goes from a
// higher or equal comp id to a lower or equal one).
struct SCC {
  const BKMaxflow& mf;
  const std::vector<uint8_t>& active;
  std::vector<int32_t> comp, low, num, stack_;
  std::vector<uint8_t> on_stack;
  int32_t counter = 0, ncomp = 0;

  SCC(const BKMaxflow& m, const std::vector<uint8_t>& act)
      : mf(m), active(act), comp(m.n, -1), low(m.n, 0), num(m.n, -1),
        on_stack(m.n, 0) {}

  void run() {
    for (int v = 0; v < mf.n; v++)
      if (active[v] && num[v] < 0) iterate(v);
  }

  void iterate(int root) {
    // explicit stack of (node, arc id)
    std::vector<std::pair<int32_t, int32_t>> call;
    call.push_back({root, mf.first_arc[root]});
    num[root] = low[root] = counter++;
    stack_.push_back(root);
    on_stack[root] = 1;
    while (!call.empty()) {
      auto& [v, ai] = call.back();
      if (ai >= 0) {
        const BKMaxflow::Arc& a = mf.arcs[ai];
        int32_t cur = ai;
        ai = mf.next_arc[ai];
        int w = a.to;
        (void)cur;
        if (a.cap <= EPS || !active[w]) continue;
        if (num[w] < 0) {
          num[w] = low[w] = counter++;
          stack_.push_back(w);
          on_stack[w] = 1;
          call.push_back({w, mf.first_arc[w]});
        } else if (on_stack[w]) {
          low[v] = std::min(low[v], num[w]);
        }
      } else {
        if (low[v] == num[v]) {
          int32_t c = ncomp++;
          while (true) {
            int w = stack_.back();
            stack_.pop_back();
            on_stack[w] = 0;
            comp[w] = c;
            if (w == v) break;
          }
        }
        int32_t lv = low[v];
        call.pop_back();
        if (!call.empty()) {
          int pv = call.back().first;
          low[pv] = std::min(low[pv], lv);
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Solve the binary MRF; returns 0 on success.
// labels_out: 0/1/-1 (unlabelled).  energy_out: energy of the labeling where
// unlabelled nodes take 0 (the fusion "keep current" completion, matching
// how rd_mex's result is consumed at dispmap_super.m:83).  lb_out: roof dual.
// regions_out (nullable): per-node strongly-connected-region id for nodes
// left unlabelled after weak persistency (-1 for labelled nodes), compacted
// to 0..R-1 — the GetRegions equivalent consumed by the reference's
// choose_labels optimal splice (vgg_qpbo.cxx / ibr_fuse_depths.m:287-375).
int qpbo_solve(int n_nodes, int n_edges,
               const double* U0, const double* U1,
               const int32_t* tails, const int32_t* heads,
               const double* E00, const double* E01, const double* E10,
               const double* E11,
               int improve,  // bit 0: QPBO-I (reserved); bit 1: skip weak
                             // persistency extension
               int32_t* labels_out, double* energy_out, double* lb_out,
               int32_t* n_unlabelled_out, int32_t* regions_out) {
  const bool use_weak = (improve & 2) == 0;
  auto U = [&](int i) { return 2 * i; };
  auto V = [&](int i) { return 2 * i + 1; };

  BKMaxflow mf(2 * n_nodes);
  mf.arcs.reserve(4 * (size_t)n_edges);
  mf.next_arc.reserve(4 * (size_t)n_edges);
  double constant = 0.0;
  std::vector<double> lin(n_nodes, 0.0);  // coefficient of x_i

  for (int i = 0; i < n_nodes; i++) {
    constant += U0[i];
    lin[i] += U1[i] - U0[i];
  }

  for (int e = 0; e < n_edges; e++) {
    int i = tails[e], j = heads[e];
    double a = E00[e], b = E01[e], c = E10[e], d = E11[e];
    constant += a;
    double B = b + c - a - d;
    if (B >= 0) {
      // th = a + (c-a)x_i + (d-c)x_j + B(1-x_i)x_j
      lin[i] += c - a;
      lin[j] += d - c;
      if (B > 0) {
        mf.add_arc(U(i), U(j), B / 2);
        mf.add_arc(V(j), V(i), B / 2);
      }
    } else {
      // z_j = ~x_j: table (a',b',c',d') = (b, a, d, c), B' = -B > 0
      // th = a' + (c'-a')x_i + (d'-c')z_j + B'(1-x_i)z_j
      // with z_j-linear weight w rewritten: w*z_j = w - w*x_j
      double ap = b, cp = d, dp = c;
      constant += ap - a;  // the complemented table's constant is a' = b
      lin[i] += cp - ap;
      constant += dp - cp;
      lin[j] -= dp - cp;
      double Bp = -B;
      mf.add_arc(U(i), V(j), Bp / 2);
      mf.add_arc(U(j), V(i), Bp / 2);
    }
  }

  for (int i = 0; i < n_nodes; i++) {
    double w = lin[i];
    if (w >= 0) {
      if (w > 0) {
        mf.add_tweights(U(i), w / 2, 0.0);
        mf.add_tweights(V(i), 0.0, w / 2);
      }
    } else {
      constant += w;
      mf.add_tweights(U(i), 0.0, -w / 2);
      mf.add_tweights(V(i), -w / 2, 0.0);
    }
  }

  double flow = mf.run();
  *lb_out = constant + flow;

  std::vector<uint8_t> src_side;
  mf.source_reachable(src_side);

  int n_unlab = 0;
  for (int i = 0; i < n_nodes; i++) {
    bool us = src_side[U(i)] != 0;  // source side -> literal 0
    bool vs = src_side[V(i)] != 0;
    if (us && !vs) {
      labels_out[i] = 0;
    } else if (!us && vs) {
      labels_out[i] = 1;
    } else {
      labels_out[i] = -1;
      n_unlab++;
    }
  }

  // Weak persistency (the ComputeWeakPersistencies equivalent,
  // QPBO_postprocessing.cpp:11): on the residual graph restricted to
  // still-unlabeled literal nodes, condense strongly connected components;
  // a variable whose two literals land in *different* components takes the
  // label dictated by the condensation's topological order (the mate
  // symmetry of the network makes this assignment consistent and
  // non-increasing).  Variables whose literals share a component stay
  // unlabeled.
  if ((use_weak || regions_out) && n_unlab > 0) {
    // all literal nodes participate — labeled nodes transit implications;
    // only unlabeled variables receive new labels
    std::vector<uint8_t> active(mf.n, 1);
    SCC scc(mf, active);
    scc.run();
    if (use_weak) {
      n_unlab = 0;
      for (int i = 0; i < n_nodes; i++) {
        if (labels_out[i] >= 0) continue;
        int32_t cu = scc.comp[U(i)], cv = scc.comp[V(i)];
        if (cu == cv || cu < 0 || cv < 0) {
          n_unlab++;
          continue;
        }
        // comp ids are in finalization (reverse-topological) order: the
        // component finalized first is downstream of every residual
        // implication; putting its literals at 1 satisfies all implications.
        labels_out[i] = (cu < cv) ? 0 : 1;
      }
    }
    if (regions_out) {
      // variables still unlabelled have comp[U] == comp[V]; group them by
      // that SCC id, compacted in first-seen order
      std::vector<int32_t> compact(scc.ncomp, -1);
      int32_t nreg = 0;
      for (int i = 0; i < n_nodes; i++) {
        if (labels_out[i] >= 0) {
          regions_out[i] = -1;
          continue;
        }
        int32_t c = scc.comp[U(i)];
        if (c < 0) {  // isolated unlabelled node: its own region
          regions_out[i] = nreg++;
          continue;
        }
        if (compact[c] < 0) compact[c] = nreg++;
        regions_out[i] = compact[c];
      }
    }
  } else if (regions_out) {
    for (int i = 0; i < n_nodes; i++) regions_out[i] = -1;
  }
  *n_unlabelled_out = n_unlab;

  // energy of the labeling with unlabelled -> 0
  double E = 0.0;
  for (int i = 0; i < n_nodes; i++)
    E += labels_out[i] == 1 ? U1[i] : U0[i];
  for (int e = 0; e < n_edges; e++) {
    int xi = labels_out[tails[e]] == 1;
    int xj = labels_out[heads[e]] == 1;
    E += xi ? (xj ? E11[e] : E10[e]) : (xj ? E01[e] : E00[e]);
  }
  *energy_out = E;
  return 0;
}

}  // extern "C"
