// Native segmentation of the stereo_tpu_torch port: a copy of
// stereo_tpu/native/segment.cpp (the port keeps its own, built by
// stereo_tpu_torch/native/__init__.py), holding the two entry points that
// proposals/segmentation.py calls.
//
// - felzenszwalb(): Efficient Graph-Based Image Segmentation (Felzenszwalb &
//   Huttenlocher, IJCV 2004) — the vgg_segment_gb equivalent
//   (imrender/vgg/seg_gb/segment-graph.h:47-80 defines the reference
//   behavior: sort 8-connected RGB-distance edges, union when the weight is
//   below both components' adaptive thresholds c/|C|, then merge components
//   smaller than min_size).  Written from the paper's algorithm; plain
//   std::vector structures.
//
// - connect_modes(): the host half of EDISON-style mean-shift segmentation
//   (vgg_segment_ms): the device filters each pixel to a (x,y,LUV) mode;
//   this routine unions 8-neighbors whose modes are within the range
//   bandwidth, transitively fuses adjacent regions with close mean modes,
//   and absorbs regions below min_region into their closest neighbor.
//   build_ram keeps the JAX package's gap, copied for parity: the last
//   row's and the last column's adjacencies are never recorded (the MATLAB
//   reference's EDISON BuildRAM adds them in two extra passes).
//
// Exposed with a C ABI for ctypes; no MATLAB/mex machinery.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <numeric>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  std::vector<int32_t> rank_;
  std::vector<int32_t> size_;
  explicit UnionFind(int n) : parent(n), rank_(n, 0), size_(n, 1) {
    std::iota(parent.begin(), parent.end(), 0);
  }
  int32_t find(int32_t a) {
    int32_t root = a;
    while (parent[root] != root) root = parent[root];
    while (parent[a] != root) {
      int32_t next = parent[a];
      parent[a] = root;
      a = next;
    }
    return root;
  }
  int32_t join(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return a;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    size_[a] += size_[b];
    if (rank_[a] == rank_[b]) rank_[a]++;
    return a;
  }
  int32_t size(int32_t a) { return size_[find(a)]; }
};

struct Edge {
  float w;
  int32_t a, b;
};

// Separable gaussian smoothing, matching the FH reference's behavior of
// clamping sigma below (segment-image.h smooths each channel before edges).
void gaussian_smooth(std::vector<float>& chan, int H, int W, float sigma) {
  sigma = std::max(sigma, 0.01f);
  const int len = std::max(1, (int)std::ceil(sigma * 4.0f)) + 1;
  std::vector<float> mask(len);
  for (int i = 0; i < len; i++)
    mask[i] = std::exp(-0.5f * (i / sigma) * (i / sigma));
  float sum = mask[0];
  for (int i = 1; i < len; i++) sum += 2.0f * mask[i];
  for (int i = 0; i < len; i++) mask[i] /= sum;

  std::vector<float> tmp(chan.size());
  // horizontal (clamped borders)
  for (int y = 0; y < H; y++) {
    for (int x = 0; x < W; x++) {
      float v = mask[0] * chan[y * W + x];
      for (int i = 1; i < len; i++) {
        int xl = std::max(x - i, 0), xr = std::min(x + i, W - 1);
        v += mask[i] * (chan[y * W + xl] + chan[y * W + xr]);
      }
      tmp[y * W + x] = v;
    }
  }
  // vertical
  for (int y = 0; y < H; y++) {
    for (int x = 0; x < W; x++) {
      float v = mask[0] * tmp[y * W + x];
      for (int i = 1; i < len; i++) {
        int yt = std::max(y - i, 0), yb = std::min(y + i, H - 1);
        v += mask[i] * (tmp[yt * W + x] + tmp[yb * W + x]);
      }
      chan[y * W + x] = v;
    }
  }
}

void compact_labels(UnionFind& uf, int n, uint32_t* labels_out) {
  std::map<int32_t, uint32_t> remap;
  for (int i = 0; i < n; i++) {
    int32_t r = uf.find(i);
    auto it = remap.find(r);
    if (it == remap.end()) {
      uint32_t id = (uint32_t)remap.size() + 1;  // 1-based like the reference
      remap[r] = id;
      labels_out[i] = id;
    } else {
      labels_out[i] = it->second;
    }
  }
}

}  // namespace

extern "C" {

// im: H*W*3 floats (row-major, channel-last, any scale).  labels_out: H*W.
// Returns the number of segments.
int felzenszwalb(const float* im, int H, int W, float sigma, float k,
                 int min_size, uint32_t* labels_out) {
  const int N = H * W;
  std::vector<float> r(N), g(N), b(N);
  for (int i = 0; i < N; i++) {
    r[i] = im[3 * i + 0];
    g[i] = im[3 * i + 1];
    b[i] = im[3 * i + 2];
  }
  gaussian_smooth(r, H, W, sigma);
  gaussian_smooth(g, H, W, sigma);
  gaussian_smooth(b, H, W, sigma);

  auto diff = [&](int p, int q) {
    float dr = r[p] - r[q], dg = g[p] - g[q], db = b[p] - b[q];
    return std::sqrt(dr * dr + dg * dg + db * db);
  };

  std::vector<Edge> edges;
  edges.reserve(4 * N);
  for (int y = 0; y < H; y++) {
    for (int x = 0; x < W; x++) {
      int p = y * W + x;
      if (x < W - 1) edges.push_back({diff(p, p + 1), p, p + 1});
      if (y < H - 1) edges.push_back({diff(p, p + W), p, p + W});
      if (x < W - 1 && y < H - 1) edges.push_back({diff(p, p + W + 1), p, p + W + 1});
      if (x < W - 1 && y > 0) edges.push_back({diff(p, p - W + 1), p, p - W + 1});
    }
  }
  std::sort(edges.begin(), edges.end(),
            [](const Edge& a, const Edge& b) { return a.w < b.w; });

  UnionFind uf(N);
  std::vector<float> threshold(N, k);  // c / |C| with |C| = 1
  for (const Edge& e : edges) {
    int32_t a = uf.find(e.a), b2 = uf.find(e.b);
    if (a == b2) continue;
    if (e.w <= threshold[a] && e.w <= threshold[b2]) {
      int32_t m = uf.join(a, b2);
      threshold[m] = e.w + k / uf.size(m);
    }
  }
  // post-process: absorb small components across any remaining edge
  for (const Edge& e : edges) {
    int32_t a = uf.find(e.a), b2 = uf.find(e.b);
    if (a != b2 && (uf.size(a) < min_size || uf.size(b2) < min_size))
      uf.join(a, b2);
  }

  compact_labels(uf, N, labels_out);
  uint32_t mx = 0;
  for (int i = 0; i < N; i++) mx = std::max(mx, labels_out[i]);
  return (int)mx;
}

namespace {

// Region classification state shared by the merge phases below: per-pixel
// region labels, per-region modes (float, EDISON stores modes as float) and
// point counts.
struct Regions {
  std::vector<int32_t> labels;  // per pixel
  std::vector<float> modes;     // 3 per region
  std::vector<int32_t> counts;  // per region
  int rc = 0;
};

// BuildRAM (msImageProcessor.cpp:2085-2210): right/below pairs over
// i < H-1, j < W-1 ONLY (the last row's horizontal and last column's
// vertical adjacencies are never recorded); per-region neighbour lists
// sorted ascending (RAList::Insert keeps label order).
std::vector<std::vector<int32_t>> build_ram(const Regions& R, int H, int W) {
  std::vector<std::vector<int32_t>> adj(R.rc);
  auto add = [&](int32_t a, int32_t b) {
    auto& v = adj[a];
    auto it = std::lower_bound(v.begin(), v.end(), b);
    if (it == v.end() || *it != b) v.insert(it, b);
  };
  for (int i = 0; i < H - 1; i++) {
    for (int j = 0; j < W - 1; j++) {
      int32_t cur = R.labels[i * W + j];
      int32_t right = R.labels[i * W + j + 1];
      int32_t bottom = R.labels[(i + 1) * W + j];
      if (cur != right) { add(cur, right); add(right, cur); }
      if (cur != bottom) { add(cur, bottom); add(bottom, cur); }
    }
  }
  return adj;
}

// InWindow (:3157-3178): range subspace only, double arithmetic, the L
// term weighted 4x when mode1's UNSCALED L exceeds 80; strict diff < 0.25.
// Asymmetric in (i, j) — TransitiveClosure effectively symmetrizes it by
// testing every adjacency from both sides.
bool in_window(const Regions& R, int32_t m1, int32_t m2, float h_r) {
  double diff = 0;
  for (int p = 0; p < 3; p++) {
    double el = (double(R.modes[3 * m1 + p]) - double(R.modes[3 * m2 + p])) /
                double(h_r);
    if (p == 0 && R.modes[3 * m1] > 80)
      diff += 4 * el * el;
    else
      diff += el * el;
  }
  return diff < 0.25;
}

// SqDistance (:3194-3218): FLOAT arithmetic; the loop's double k++ limits
// it to the range subspace (no spatial terms, no L-quirk).
float sq_distance(const Regions& R, int32_t m1, int32_t m2, float h_r) {
  float dist = 0;
  for (int p = 0; p < 3; p++) {
    float el = (R.modes[3 * m1 + p] - R.modes[3 * m2 + p]) / h_r;
    dist += el * el;
  }
  return dist;
}

// Steps 3-4 shared by TransitiveClosure and Prune (:2437-2535): resolve the
// joins, accumulate float count-weighted modes by canonical element in
// ascending region order, relabel by first occurrence (equal to ascending
// minimum-member order), rebuild the pixel label map.
void relabel(Regions& R, UnionFind& uf) {
  std::vector<float> modes_buffer(3 * R.rc, 0.0f);
  std::vector<int64_t> mpc_buffer(R.rc, 0);
  for (int32_t i = 0; i < R.rc; i++) {
    int32_t c = uf.find(i);
    float w = float(R.counts[i]);
    for (int p = 0; p < 3; p++) modes_buffer[3 * c + p] += w * R.modes[3 * i + p];
    mpc_buffer[c] += R.counts[i];
  }
  std::vector<int32_t> label_buffer(R.rc, -1);
  std::vector<float> new_modes;
  std::vector<int32_t> new_counts;
  int32_t label = -1;
  for (int32_t i = 0; i < R.rc; i++) {
    int32_t c = uf.find(i);
    if (label_buffer[c] < 0) {
      label_buffer[c] = ++label;
      for (int p = 0; p < 3; p++)
        new_modes.push_back(modes_buffer[3 * c + p] / float(mpc_buffer[c]));
      new_counts.push_back((int32_t)mpc_buffer[c]);
    }
  }
  for (auto& l : R.labels) l = label_buffer[uf.find(l)];
  R.modes = std::move(new_modes);
  R.counts = std::move(new_counts);
  R.rc = label + 1;
}

// TransitiveClosure (:2349-2545): join every RAM adjacency passing
// InWindow from either side, then relabel.  The join set is fixed by the
// pass-start modes, so textbook union-find reproduces the reference's
// canonical-element merge exactly (the partition is the connected
// components of the join graph either way).
void transitive_closure(Regions& R, int H, int W, float h_r) {
  auto adj = build_ram(R, H, W);
  UnionFind uf(R.rc);
  for (int32_t i = 0; i < R.rc; i++)
    for (int32_t j : adj[i])
      if (in_window(R, i, j, h_r)) uf.join(i, j);
  relabel(R, uf);
}

}  // namespace

// modes: H*W*3 filtered LUV modes (device mean-shift output).
// Returns number of segments (labels are 1-based).
//
// Control-flow-faithful transcription of the post-filter phases of EDISON's
// Segment (msImageProcessor.cpp:703-800), pinned against the independent
// numpy transcription in tests/oracle_meanshift.py:
//
//   1. Connect (:1911-1958) + Fill (:1982-2064): components over pixels
//      whose float modes differ < LUV_treshold = 1.0 per channel — with the
//      reference's commented-out column-bound check, so the 8 neighbour
//      offsets are applied to the LINEAR index and wrap across row ends;
//      region modes are the raster-first seed pixel's values.
//   2. TransitiveClosure in Segment's repetition pattern (:744-752).
//   3. Prune (:2734-2965): iteratively absorb regions with counts <
//      min_region into the adjacent region of minimum SqDistance
//      (pass-start modes, lowest label first, strict improvement).
int connect_modes(const float* modes, int H, int W, float h_r, int min_region,
                  uint32_t* labels_out) {
  const int N = H * W;

  // --- Connect: wrap-quirk 8-neighbour components over |delta| < 1/channel
  const int neigh[8] = {1, 1 - W, -W, -(1 + W), -1, W - 1, W, W + 1};
  UnionFind pix(N);
  for (int p = 0; p < N; p++) {
    for (int k = 0; k < 8; k++) {
      int q = p + neigh[k];
      if (q < 0 || q >= N || q < p) continue;  // each pair tested once
      bool close = true;
      for (int c = 0; c < 3 && close; c++)
        close = std::fabs(modes[3 * p + c] - modes[3 * q + c]) < 1.0f;
      if (close) pix.join(p, q);
    }
  }
  Regions R;
  R.labels.resize(N);
  {
    std::vector<int32_t> remap(N, -1);
    for (int p = 0; p < N; p++) {
      int32_t r = pix.find(p);
      if (remap[r] < 0) {
        remap[r] = R.rc++;
        for (int c = 0; c < 3; c++) R.modes.push_back(modes[3 * p + c]);
        R.counts.push_back(0);
      }
      R.labels[p] = remap[r];
      R.counts[remap[r]]++;
    }
  }

  // --- TransitiveClosure, once + the reference's do-while repetition
  transitive_closure(R, H, W, h_r);
  int old_rc = R.rc, counter = 0, delta;
  do {
    transitive_closure(R, H, W, h_r);
    delta = old_rc - R.rc;
    old_rc = R.rc;
    counter++;
  } while (delta <= 0 && counter < 10);

  // --- Prune: repeat while any region was below min_region
  int min_region_count;
  do {
    min_region_count = 0;
    auto adj = build_ram(R, H, W);
    UnionFind uf(R.rc);
    for (int32_t i = 0; i < R.rc; i++) {
      if (R.counts[i] < min_region && !adj[i].empty()) {
        min_region_count++;
        int32_t candidate = adj[i][0];
        float best = sq_distance(R, i, candidate, h_r);
        for (size_t k = 1; k < adj[i].size(); k++) {
          float d = sq_distance(R, i, adj[i][k], h_r);
          if (d < best) {  // strict: ties keep the earlier label
            best = d;
            candidate = adj[i][k];
          }
        }
        uf.join(i, candidate);
      }
    }
    relabel(R, uf);
  } while (min_region_count > 0);

  for (int p = 0; p < N; p++) labels_out[p] = (uint32_t)R.labels[p] + 1;
  return R.rc;
}

}  // extern "C"
