// Native host-side scene compiler: midpoint-split KD/AABB tree builder.
//
// crt_tpu counterpart of the reference's load-time tree build
// (reference src/core/crt_acceleration_tree.cpp:31-106, invoked from
// crt_json.cpp:606).  The device consumes only flat SoA arrays, so this
// builder produces exactly the structures crt_tpu.scene.accel flattens:
// node AABBs, child indices, and per-leaf triangle-id lists.  Semantics are
// identical to the reference build:
//   - root = union of triangle AABBs
//   - midpoint split, axis = depth % 3
//   - triangles routed by inclusive AABB overlap, duplicated on straddle
//   - child0's subtree numbered before child1
//   - leaf when count <= max_leaf or depth > max_depth
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Builder {
    const float *tmin;  // [T][3]
    const float *tmax;  // [T][3]
    int32_t max_depth;
    int32_t max_leaf;

    std::vector<float> node_min;       // [N*3]
    std::vector<float> node_max;       // [N*3]
    std::vector<int32_t> node_children;  // [N*2]
    std::vector<int32_t> node_leaf_id;   // [N]
    std::vector<std::vector<int32_t>> leaves;  // per-leaf triangle ids
    std::vector<int32_t> leaf_node;    // owning node per leaf

    int32_t add_node(const float mn[3], const float mx[3]) {
        int32_t id = static_cast<int32_t>(node_leaf_id.size());
        node_min.insert(node_min.end(), mn, mn + 3);
        node_max.insert(node_max.end(), mx, mx + 3);
        node_children.push_back(-1);
        node_children.push_back(-1);
        node_leaf_id.push_back(-1);
        return id;
    }

    void make_leaf(int32_t node, std::vector<int32_t> tris) {
        node_leaf_id[node] = static_cast<int32_t>(leaves.size());
        leaf_node.push_back(node);
        leaves.push_back(std::move(tris));
    }

    void build_branch(int32_t parent, std::vector<int32_t> tris, int32_t depth) {
        if (depth > max_depth ||
            static_cast<int32_t>(tris.size()) <= max_leaf) {
            make_leaf(parent, std::move(tris));
            return;
        }

        const int axis = depth % 3;
        const float bmin = node_min[parent * 3 + axis];
        const float bmax = node_max[parent * 3 + axis];
        const float mid = (bmin + bmax) * 0.5f;

        float c0_min[3], c0_max[3], c1_min[3], c1_max[3];
        for (int k = 0; k < 3; ++k) {
            c0_min[k] = node_min[parent * 3 + k];
            c0_max[k] = node_max[parent * 3 + k];
            c1_min[k] = c0_min[k];
            c1_max[k] = c0_max[k];
        }
        c0_max[axis] = mid;
        c1_min[axis] = mid;

        std::vector<int32_t> t0, t1;
        t0.reserve(tris.size());
        t1.reserve(tris.size() / 2);
        for (int32_t t : tris) {
            const float *lo = tmin + 3 * t;
            const float *hi = tmax + 3 * t;
            bool in0 = true, in1 = true;
            for (int k = 0; k < 3; ++k) {
                if (lo[k] > c0_max[k] || hi[k] < c0_min[k]) in0 = false;
                if (lo[k] > c1_max[k] || hi[k] < c1_min[k]) in1 = false;
            }
            if (in0) t0.push_back(t);
            if (in1) t1.push_back(t);
        }
        tris.clear();
        tris.shrink_to_fit();

        if (!t0.empty()) {
            int32_t c0 = add_node(c0_min, c0_max);
            node_children[parent * 2 + 0] = c0;
            build_branch(c0, std::move(t0), depth + 1);
        }
        if (!t1.empty()) {
            int32_t c1 = add_node(c1_min, c1_max);
            node_children[parent * 2 + 1] = c1;
            build_branch(c1, std::move(t1), depth + 1);
        }
    }
};

}  // namespace

extern "C" {

void *crt_accel_build(const float *tmin, const float *tmax, int32_t T,
                      int32_t max_depth, int32_t max_leaf) {
    if (T <= 0) return nullptr;  // root-box seed below reads tmin/tmax[0..2]
    auto *b = new Builder{tmin, tmax, max_depth, max_leaf, {}, {}, {}, {}, {}, {}};

    float rmin[3] = {tmin[0], tmin[1], tmin[2]};
    float rmax[3] = {tmax[0], tmax[1], tmax[2]};
    for (int32_t t = 1; t < T; ++t) {
        for (int k = 0; k < 3; ++k) {
            rmin[k] = std::min(rmin[k], tmin[3 * t + k]);
            rmax[k] = std::max(rmax[k], tmax[3 * t + k]);
        }
    }
    b->add_node(rmin, rmax);

    std::vector<int32_t> all(T);
    for (int32_t t = 0; t < T; ++t) all[t] = t;
    b->build_branch(0, std::move(all), 0);
    return b;
}

int32_t crt_accel_num_nodes(void *h) {
    return static_cast<int32_t>(static_cast<Builder *>(h)->node_leaf_id.size());
}

int32_t crt_accel_num_leaves(void *h) {
    return static_cast<int32_t>(static_cast<Builder *>(h)->leaves.size());
}

int32_t crt_accel_max_leaf_count(void *h) {
    int32_t m = 0;
    for (const auto &l : static_cast<Builder *>(h)->leaves)
        m = std::max(m, static_cast<int32_t>(l.size()));
    return m;
}

// leaf_tris must be [num_leaves * leaf_stride], pre-filled with -1.
void crt_accel_export(void *h, float *node_min, float *node_max,
                      int32_t *node_children, int32_t *node_leaf_id,
                      int32_t *leaf_tris, int32_t leaf_stride,
                      int32_t *leaf_node) {
    auto *b = static_cast<Builder *>(h);
    std::copy(b->node_min.begin(), b->node_min.end(), node_min);
    std::copy(b->node_max.begin(), b->node_max.end(), node_max);
    std::copy(b->node_children.begin(), b->node_children.end(), node_children);
    std::copy(b->node_leaf_id.begin(), b->node_leaf_id.end(), node_leaf_id);
    std::copy(b->leaf_node.begin(), b->leaf_node.end(), leaf_node);
    for (size_t li = 0; li < b->leaves.size(); ++li) {
        const auto &l = b->leaves[li];
        std::copy(l.begin(), l.end(), leaf_tris + li * leaf_stride);
    }
}

void crt_accel_free(void *h) { delete static_cast<Builder *>(h); }

}  // extern "C"
