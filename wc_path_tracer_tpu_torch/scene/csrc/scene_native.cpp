// Native host-side scene pipeline: OBJ parsing + median-split BVH build.
//
// The PyTorch port's copy of the JAX package's native/scene_native.cpp, with
// the same three C exports and the same code.  The reference performs both
// in compiled native host code (Jai):
//   - BVH build: src/PathTracingRenderer.jai:147-217
//   - OBJ parse: src/ModelLoader.jai:60-141
// This C++ implementation reproduces the same semantics as the port's NumPy
// builder (scene/bvh.py) and Python parser (models/obj.py), which are the
// readable oracles (tests/test_torch_native.py holds the trees equal bit for
// bit) but runs ~10-100x faster on large meshes, keeping the host scene
// build short.  scene/native.py builds it with g++ -ffp-contract=off (no
// fused multiply-adds, no -march=native), so its float32 rounding is the
// NumPy builder's on any host.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <algorithm>
#include <numeric>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BVH build
// ---------------------------------------------------------------------------
// Node layout matches scene/bvh.py BVH (leaf iff count>0; inner children are
// left and left+1). Returns the number of nodes written, or -1 on capacity
// overflow. indices is permuted in place; tri_order[t] maps the new triangle
// slot t to the original triangle id.

struct BuildNode {
  float mn[3], mx[3];
  int32_t left;   // first index (leaf) or left child (inner)
  int32_t count;  // index count (leaf) or 0 (inner)
};

static void node_bounds(const float* verts, const int32_t* indices, int32_t first,
                        int32_t count, float* mn, float* mx) {
  mn[0] = mn[1] = mn[2] = 3.402823466e38f;
  mx[0] = mx[1] = mx[2] = -3.402823466e38f;
  for (int32_t i = 0; i < count; ++i) {
    const float* v = verts + 3 * indices[first + i];
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], v[k]);
      mx[k] = std::max(mx[k], v[k]);
    }
  }
}

int32_t wc_build_bvh(const float* verts, int32_t /*n_verts*/, int32_t* indices,
                     int32_t n_indices, int32_t leaf_index_count,
                     int32_t max_depth, int32_t robust, float* out_min,
                     float* out_max, int32_t* out_left, int32_t* out_count,
                     int32_t* tri_order, int32_t node_capacity) {
  const int32_t n_tris = n_indices / 3;
  for (int32_t t = 0; t < n_tris; ++t) tri_order[t] = t;

  std::vector<BuildNode> nodes;
  nodes.reserve(std::min<int64_t>(2 * (int64_t)n_tris, node_capacity));

  // centroid cache (per current triangle slot; swapped alongside indices)
  std::vector<float> cent(3 * (size_t)n_tris);
  for (int32_t t = 0; t < n_tris; ++t) {
    for (int k = 0; k < 3; ++k) {
      cent[3 * t + k] = (verts[3 * indices[3 * t] + k] +
                         verts[3 * indices[3 * t + 1] + k] +
                         verts[3 * indices[3 * t + 2] + k]) /
                        3.0f;
    }
  }

  BuildNode root;
  node_bounds(verts, indices, 0, n_indices, root.mn, root.mx);
  root.left = 0;
  root.count = n_indices;
  nodes.push_back(root);

  std::vector<std::pair<int32_t, int32_t>> stack;  // (node, depth)
  stack.emplace_back(0, max_depth);

  std::vector<int32_t> order;  // scratch for robust median split

  while (!stack.empty()) {
    auto [ni, depth] = stack.back();
    stack.pop_back();
    BuildNode& node = nodes[ni];
    if (node.count <= leaf_index_count || depth == 0) continue;

    const int32_t first = node.left, count = node.count;
    const int32_t t0 = first / 3, tcount = count / 3;

    float extent[3] = {node.mx[0] - node.mn[0], node.mx[1] - node.mn[1],
                       node.mx[2] - node.mn[2]};
    int axis = 0;                       // exact reference axis pick (:172-175)
    if (extent[1] > extent[0]) axis = 1;
    if (extent[2] > extent[axis]) axis = 2;
    const float split = node.mn[axis] + extent[axis] * 0.5f;

    // partition triangle slots [t0, t0+tcount) by centroid < split
    order.resize(tcount);
    std::iota(order.begin(), order.end(), 0);
    int32_t left_tris = 0;
    {
      // stable partition to mirror the NumPy where()-concatenation order
      std::stable_partition(order.begin(), order.end(), [&](int32_t t) {
        return cent[3 * (t0 + t) + axis] < split;
      });
      for (int32_t t = 0; t < tcount; ++t)
        if (cent[3 * (t0 + order[t]) + axis] < split) ++left_tris;
    }

    if (left_tris == 0 || left_tris == tcount) {
      if (!robust) continue;  // reference bailout (:193): stays a big leaf
      // robust: median split by centroid. Membership = smallest half under a
      // stable sort; slot order within each side stays the original order
      // (mirrors the NumPy where()-mask formulation in scene/bvh.py).
      std::iota(order.begin(), order.end(), 0);
      std::vector<int32_t> sorted = order;
      std::stable_sort(sorted.begin(), sorted.end(), [&](int32_t a, int32_t b) {
        return cent[3 * (t0 + a) + axis] < cent[3 * (t0 + b) + axis];
      });
      left_tris = tcount / 2;
      if (left_tris == 0) continue;
      std::vector<char> in_left(tcount, 0);
      for (int32_t t = 0; t < left_tris; ++t) in_left[sorted[t]] = 1;
      std::stable_partition(order.begin(), order.end(),
                            [&](int32_t t) { return in_left[t] != 0; });
    }

    // apply permutation to indices, centroids and tri_order
    {
      std::vector<int32_t> idx_tmp(count);
      std::vector<float> cent_tmp(3 * (size_t)tcount);
      std::vector<int32_t> ord_tmp(tcount);
      for (int32_t t = 0; t < tcount; ++t) {
        const int32_t src = order[t];
        std::memcpy(&idx_tmp[3 * t], &indices[first + 3 * src],
                    3 * sizeof(int32_t));
        std::memcpy(&cent_tmp[3 * t], &cent[3 * (t0 + src)], 3 * sizeof(float));
        ord_tmp[t] = tri_order[t0 + src];
      }
      std::memcpy(&indices[first], idx_tmp.data(), count * sizeof(int32_t));
      std::memcpy(&cent[3 * t0], cent_tmp.data(),
                  3 * (size_t)tcount * sizeof(float));
      std::memcpy(&tri_order[t0], ord_tmp.data(), tcount * sizeof(int32_t));
    }

    const int32_t left_count = left_tris * 3;
    if ((int32_t)nodes.size() + 2 > node_capacity) return -1;

    BuildNode lchild, rchild;
    lchild.left = first;
    lchild.count = left_count;
    node_bounds(verts, indices, first, left_count, lchild.mn, lchild.mx);
    rchild.left = first + left_count;
    rchild.count = count - left_count;
    node_bounds(verts, indices, rchild.left, rchild.count, rchild.mn,
                rchild.mx);

    const int32_t li = (int32_t)nodes.size();
    nodes.push_back(lchild);
    nodes.push_back(rchild);
    nodes[ni].left = li;
    nodes[ni].count = 0;
    stack.emplace_back(li + 1, depth - 1);
    stack.emplace_back(li, depth - 1);
  }

  const int32_t n = (int32_t)nodes.size();
  for (int32_t i = 0; i < n; ++i) {
    std::memcpy(out_min + 3 * i, nodes[i].mn, 3 * sizeof(float));
    std::memcpy(out_max + 3 * i, nodes[i].mx, 3 * sizeof(float));
    out_left[i] = nodes[i].left;
    out_count[i] = nodes[i].count;
  }
  return n;
}

// ---------------------------------------------------------------------------
// OBJ parse
// ---------------------------------------------------------------------------
// Two-pass C parser with (v, vt, vn)-triple dedup and fan triangulation,
// matching models/obj.py. Caller owns the returned buffers via wc_obj_free.

struct ObjResult {
  float* vertices;  // (V,3)
  float* normals;   // (V,3)
  float* uvs;       // (V,2)
  int32_t* indices; // (I,)
  int32_t n_vertices;
  int32_t n_indices;
};

struct Key {
  int32_t v, vt, vn;
  bool operator==(const Key& o) const {
    return v == o.v && vt == o.vt && vn == o.vn;
  }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    size_t h = 1469598103934665603ull;
    for (int32_t x : {k.v, k.vt, k.vn}) {
      h ^= (uint32_t)x;
      h *= 1099511628211ull;
    }
    return h;
  }
};

ObjResult* wc_parse_obj(const char* text, int64_t length) {
  std::vector<float> pos, uv, nrm;
  std::vector<float> out_pos, out_uv, out_nrm;
  std::vector<int32_t> out_idx;
  std::unordered_map<Key, int32_t, KeyHash> dedup;
  std::vector<int32_t> face;

  const char* p = text;
  const char* end = text + length;
  auto skip_ws = [&](const char*& q) {
    while (q < end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
  };

  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    const char* q = p;
    skip_ws(q);
    if (q + 1 < line_end && q[0] == 'v' &&
        (q[1] == ' ' || q[1] == '\t')) {
      char* e;
      float x = strtof(q + 1, &e), y = strtof(e, &e), z = strtof(e, &e);
      pos.insert(pos.end(), {x, y, z});
    } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 't' &&
               (q[2] == ' ' || q[2] == '\t')) {
      char* e;
      float u = strtof(q + 2, &e), v = strtof(e, &e);
      uv.insert(uv.end(), {u, v});
    } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n' &&
               (q[2] == ' ' || q[2] == '\t')) {
      char* e;
      float x = strtof(q + 2, &e), y = strtof(e, &e), z = strtof(e, &e);
      nrm.insert(nrm.end(), {x, y, z});
    } else if (q < line_end && q[0] == 'f' &&
               (q + 1 == line_end || q[1] == ' ' || q[1] == '\t')) {
      face.clear();
      const char* w = q + 1;
      while (w < line_end) {
        skip_ws(w);
        if (w >= line_end) break;
        // parse i[/j[/k]]
        char* e;
        long vi = strtol(w, &e, 10);
        long ti = 0, ni = 0;
        bool has_t = false, has_n = false;
        if (e < line_end && *e == '/') {
          const char* e2 = e + 1;
          if (e2 < line_end && *e2 != '/') {
            ti = strtol(e2, &e, 10);
            has_t = true;
          } else {
            e = (char*)e2;
          }
          if (e < line_end && *e == '/') {
            ni = strtol(e + 1, &e, 10);
            has_n = true;
          }
        }
        if (e == w) break;
        w = e;
        Key key{(int32_t)(vi - 1), has_t ? (int32_t)(ti - 1) : -1,
                has_n ? (int32_t)(ni - 1) : -1};
        auto it = dedup.find(key);
        int32_t idx;
        if (it != dedup.end()) {
          idx = it->second;
        } else {
          idx = (int32_t)(out_pos.size() / 3);
          dedup.emplace(key, idx);
          if (key.v >= 0 && 3 * key.v + 2 < (int32_t)pos.size())
            out_pos.insert(out_pos.end(), {pos[3 * key.v], pos[3 * key.v + 1],
                                           pos[3 * key.v + 2]});
          else
            out_pos.insert(out_pos.end(), {0, 0, 0});
          if (key.vt >= 0 && 2 * key.vt + 1 < (int32_t)uv.size())
            out_uv.insert(out_uv.end(), {uv[2 * key.vt], uv[2 * key.vt + 1]});
          else
            out_uv.insert(out_uv.end(), {0, 0});
          if (key.vn >= 0 && 3 * key.vn + 2 < (int32_t)nrm.size())
            out_nrm.insert(out_nrm.end(), {nrm[3 * key.vn],
                                           nrm[3 * key.vn + 1],
                                           nrm[3 * key.vn + 2]});
          else
            out_nrm.insert(out_nrm.end(), {0, 0, 0});
        }
        face.push_back(idx);
      }
      for (size_t i = 1; i + 1 < face.size(); ++i) {  // fan triangulation
        out_idx.push_back(face[0]);
        out_idx.push_back(face[i]);
        out_idx.push_back(face[i + 1]);
      }
    }
    p = line_end + 1;
  }

  ObjResult* r = new ObjResult;
  r->n_vertices = (int32_t)(out_pos.size() / 3);
  r->n_indices = (int32_t)out_idx.size();
  r->vertices = (float*)malloc(out_pos.size() * sizeof(float));
  r->normals = (float*)malloc(out_nrm.size() * sizeof(float));
  r->uvs = (float*)malloc(out_uv.size() * sizeof(float));
  r->indices = (int32_t*)malloc(out_idx.size() * sizeof(int32_t));
  std::memcpy(r->vertices, out_pos.data(), out_pos.size() * sizeof(float));
  std::memcpy(r->normals, out_nrm.data(), out_nrm.size() * sizeof(float));
  std::memcpy(r->uvs, out_uv.data(), out_uv.size() * sizeof(float));
  std::memcpy(r->indices, out_idx.data(), out_idx.size() * sizeof(int32_t));
  return r;
}

void wc_obj_free(ObjResult* r) {
  if (!r) return;
  free(r->vertices);
  free(r->normals);
  free(r->uvs);
  free(r->indices);
  delete r;
}

}  // extern "C"
