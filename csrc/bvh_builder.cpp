// Native binned-SAH BVH builder — the C++ runtime component behind
// ops/sah.py.
//
// Re-designs (does NOT translate) the reference's SAH build
// (BVH.cpp:60-339): the reference runs a 32-step binary search for the
// split plane per axis with incremental object migration; here we use
// the standard 16-bin SAH sweep (same cost model, N_L*SA_L + N_R*SA_R,
// BVH.cpp:53-58) which is O(N) per level and produces comparable trees.
// Output (ops/sah.py re-orders the triangles into compact leaves and
// ops/cuda_bvh.py lays the nodes out for csrc/bvh_trace.cu):
//
//   * per leaf, its triangle indices, padded to LEAF_CAP slots (-1 pad);
//   * per internal node: both children's AABBs + child links
//     (>=0: internal node id; <0: ~leaf id), so a visit is one row
//     fetch.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this
// image). Build: make -C csrc
//
// Leaf rule: subdivide while > LEAF_CAP triangles; if SAH refuses to
// split (all centroids in one bin), fall back to a median split so
// leaves never exceed LEAF_CAP.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBins = 16;

struct Box {
  float lo[3] = {1e30f, 1e30f, 1e30f};
  float hi[3] = {-1e30f, -1e30f, -1e30f};
  void grow(const float* l, const float* h) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], l[a]);
      hi[a] = std::max(hi[a], h[a]);
    }
  }
  void grow(const Box& b) { grow(b.lo, b.hi); }
  float area() const {
    float dx = std::max(0.f, hi[0] - lo[0]);
    float dy = std::max(0.f, hi[1] - lo[1]);
    float dz = std::max(0.f, hi[2] - lo[2]);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Node {
  Box box_l, box_r;
  int32_t child_l = 0, child_r = 0;  // >=0 internal, <0 => ~leaf_id
};

struct Builder {
  const float* lo;        // (N,3) per-tri AABB min
  const float* hi;        // (N,3) per-tri AABB max
  const float* cent;      // (N,3) centroids
  int leaf_cap;
  std::vector<int32_t> order;      // work array of tri indices
  std::vector<Node> nodes;
  std::vector<int32_t> leaf_tris;  // leaf_cap per leaf, -1 padded
  int max_depth = 0;

  Box tri_box(int i) const {
    Box b;
    b.grow(lo + 3 * i, hi + 3 * i);
    return b;
  }

  Box range_box(int s, int e) const {
    Box b;
    for (int i = s; i < e; ++i) b.grow(lo + 3 * order[i], hi + 3 * order[i]);
    return b;
  }

  int make_leaf(int s, int e) {
    int leaf_id = static_cast<int>(leaf_tris.size()) / leaf_cap;
    for (int i = s; i < e; ++i) leaf_tris.push_back(order[i]);
    for (int i = e - s; i < leaf_cap; ++i) leaf_tris.push_back(-1);
    return ~leaf_id;
  }

  // returns child link for range [s, e)
  int build(int s, int e, const Box& bounds, int depth) {
    max_depth = std::max(max_depth, depth);
    if (e - s <= leaf_cap) return make_leaf(s, e);

    // centroid bounds pick the split axis (degenerate -> median split)
    Box cb;
    for (int i = s; i < e; ++i) {
      const float* c = cent + 3 * order[i];
      cb.grow(c, c);
    }
    int axis = 0;
    float ext[3] = {cb.hi[0] - cb.lo[0], cb.hi[1] - cb.lo[1],
                    cb.hi[2] - cb.lo[2]};
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid = -1;
    if (ext[axis] > 1e-12f) {
      // binned SAH sweep (cost model BVH.cpp:53-58)
      Box bin_box[kBins];
      int bin_cnt[kBins] = {0};
      float scale = kBins / ext[axis];
      auto bin_of = [&](int tri) {
        int b = static_cast<int>((cent[3 * tri + axis] - cb.lo[axis])
                                 * scale);
        return std::min(b, kBins - 1);
      };
      for (int i = s; i < e; ++i) {
        int b = bin_of(order[i]);
        bin_box[b].grow(tri_box(order[i]));
        bin_cnt[b]++;
      }
      // suffix sweep
      Box rbox[kBins];
      int rcnt[kBins];
      Box acc;
      int cnt = 0;
      for (int b = kBins - 1; b >= 0; --b) {
        acc.grow(bin_box[b]);
        cnt += bin_cnt[b];
        rbox[b] = acc;
        rcnt[b] = cnt;
      }
      // prefix sweep picks the best plane
      float best_cost = 1e30f;
      int best_plane = -1;
      Box lacc;
      int lcnt = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        lacc.grow(bin_box[b]);
        lcnt += bin_cnt[b];
        if (lcnt == 0 || rcnt[b + 1] == 0) continue;
        float cost = lacc.area() * lcnt + rbox[b + 1].area() * rcnt[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_plane = b;
        }
      }
      if (best_plane >= 0) {
        auto it = std::partition(
            order.begin() + s, order.begin() + e,
            [&](int tri) { return bin_of(tri) <= best_plane; });
        mid = static_cast<int>(it - order.begin());
        if (mid == s || mid == e) mid = -1;
      }
    }
    if (mid < 0) {
      // median fallback keeps leaves within the fixed packet size
      mid = s + (e - s) / 2;
      std::nth_element(order.begin() + s, order.begin() + mid,
                       order.begin() + e, [&](int a, int b) {
                         return cent[3 * a + axis] < cent[3 * b + axis];
                       });
    }

    Box bl = range_box(s, mid);
    Box br = range_box(mid, e);
    int node_id = static_cast<int>(nodes.size());
    nodes.emplace_back();
    int cl = build(s, mid, bl, depth + 1);
    int cr = build(mid, e, br, depth + 1);
    nodes[node_id].box_l = bl;
    nodes[node_id].box_r = br;
    nodes[node_id].child_l = cl;
    nodes[node_id].child_r = cr;
    return node_id;
  }
};

}  // namespace

extern "C" {

// Two-phase API: build once (returns a handle), query sizes, copy out,
// free. All arrays are float32/int32, C-contiguous.
struct BVHHandle {
  Builder b;
};

BVHHandle* bvh_build(const float* lo, const float* hi, const float* cent,
                     int32_t n, int32_t leaf_cap) {
  auto* h = new BVHHandle();
  h->b.lo = lo;
  h->b.hi = hi;
  h->b.cent = cent;
  h->b.leaf_cap = leaf_cap;
  h->b.order.resize(n);
  for (int i = 0; i < n; ++i) h->b.order[i] = i;
  h->b.nodes.reserve(2 * n / leaf_cap + 2);
  h->b.leaf_tris.reserve(n + leaf_cap);
  if (n == 0) {
    h->b.make_leaf(0, 0);
    h->b.nodes.emplace_back();  // root with two empty boxes
    h->b.nodes[0].child_l = ~0;
    h->b.nodes[0].child_r = ~0;
    return h;
  }
  Box root = h->b.range_box(0, n);
  int r = h->b.build(0, n, root, 0);
  if (r < 0) {
    // single leaf: wrap in one internal node (kernel starts at node 0)
    Node nd;
    nd.box_l = root;
    nd.child_l = r;
    nd.child_r = ~(static_cast<int>(h->b.leaf_tris.size()) / leaf_cap);
    h->b.leaf_tris.insert(h->b.leaf_tris.end(), leaf_cap, -1);
    // box_r stays at the never-hit default (+inf/-inf slab fails)
    h->b.nodes.push_back(nd);
    std::rotate(h->b.nodes.begin(), h->b.nodes.end() - 1,
                h->b.nodes.end());
    // rotating a single element list of size 1 is a no-op; nodes was
    // empty before push, so node 0 is the wrapper as required
  }
  return h;
}

int32_t bvh_num_nodes(BVHHandle* h) {
  return static_cast<int32_t>(h->b.nodes.size());
}
int32_t bvh_num_leaves(BVHHandle* h) {
  return static_cast<int32_t>(h->b.leaf_tris.size()) / h->b.leaf_cap;
}
int32_t bvh_max_depth(BVHHandle* h) { return h->b.max_depth; }

// nodes_out: (num_nodes, 14) f32 rows [loL(3) hiL(3) loR(3) hiR(3)
//            childL childR] (child links stored as exact small floats)
// leaf_out:  (num_leaves * leaf_cap,) i32 triangle ids, -1 padding
void bvh_export(BVHHandle* h, float* nodes_out, int32_t* leaf_out) {
  const auto& nodes = h->b.nodes;
  for (size_t i = 0; i < nodes.size(); ++i) {
    float* r = nodes_out + 14 * i;
    std::memcpy(r + 0, nodes[i].box_l.lo, 12);
    std::memcpy(r + 3, nodes[i].box_l.hi, 12);
    std::memcpy(r + 6, nodes[i].box_r.lo, 12);
    std::memcpy(r + 9, nodes[i].box_r.hi, 12);
    r[12] = static_cast<float>(nodes[i].child_l);
    r[13] = static_cast<float>(nodes[i].child_r);
  }
  std::memcpy(leaf_out, h->b.leaf_tris.data(),
              h->b.leaf_tris.size() * sizeof(int32_t));
}

void bvh_free(BVHHandle* h) { delete h; }

}  // extern "C"
