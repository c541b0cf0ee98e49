// Native mesh surgery for density control.
//
// The greedy longest-edge collapse (reference geometry_ops.py:79-167)
// is inherently sequential; the numpy port costs O(V) per collapse
// (collapse_map relabel scan), i.e. minutes at the 1e5-2e5 gaussian
// scale the training recipes reach (human_complex.yaml: max 2e5,
// prune_max_n_gs_once=5000, ~5 prune events per run). This C++
// implementation keeps per-vertex adjacency and a lazy max-heap, making
// each collapse O(deg log E) — the whole prune runs in milliseconds.
//
// Exposed via a plain C ABI and loaded with ctypes;
// sings_tpu_torch/mesh/native.py builds it on first use with g++ and
// falls back to the numpy implementation if unavailable. Host code, a
// copy of sings_tpu/native/mesh_native.cpp (the port imports nothing of
// that package).
//
// Semantics match mesh/ops.collapse_edges exactly (same greedy order up
// to float ties): collapse v2 -> v1 keeping v1's position/attributes,
// drop degenerate + duplicate faces, return a keep-mask and faces
// relabeled to ORIGINAL vertex ids (callers reindex as needed).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <queue>
#include <unordered_set>
#include <vector>

namespace {

struct HeapEntry {
    float len;
    int32_t a, b;  // edge endpoints (current representatives)
};

struct HeapCmp {
    bool operator()(const HeapEntry& x, const HeapEntry& y) const {
        return x.len < y.len;  // max-heap on length
    }
};

inline uint64_t ekey(int32_t a, int32_t b) {
    if (a > b) std::swap(a, b);
    return (static_cast<uint64_t>(a) << 32) | static_cast<uint32_t>(b);
}

inline float edge_len(const float* v, int32_t a, int32_t b) {
    float dx = v[3 * a] - v[3 * b];
    float dy = v[3 * a + 1] - v[3 * b + 1];
    float dz = v[3 * a + 2] - v[3 * b + 2];
    return std::sqrt(dx * dx + dy * dy + dz * dz);
}

}  // namespace

extern "C" {

// Returns the number of collapses performed.
// verts:      (n_verts, 3) float32, modified in place (v2 <- v1)
// attrs:      (n_verts, attr_dim) float32, modified in place
// sel_edges:  (n_sel, 2) int32 candidate edges
// faces:      (n_faces, 3) int32, relabeled in place to representatives
// face_keep:  (n_faces,) uint8 out: 1 = face survives
// vert_keep:  (n_verts,) uint8 out: 1 = vertex survives (referenced by
//             a surviving face)
int32_t collapse_edges_native(
    float* verts, int64_t n_verts,
    float* attrs, int64_t attr_dim,
    const int32_t* sel_edges, int64_t n_sel,
    int32_t* faces, int64_t n_faces,
    uint8_t* face_keep, uint8_t* vert_keep,
    double collapse_rate) {

    // union-find over vertices (path compression)
    std::vector<int32_t> parent(n_verts);
    for (int64_t i = 0; i < n_verts; ++i) parent[i] = (int32_t)i;
    std::vector<int32_t> stack;
    auto find = [&](int32_t x) {
        int32_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) { int32_t nx = parent[x]; parent[x] = root; x = nx; }
        return root;
    };

    std::vector<uint8_t> vert_del(n_verts, 0);

    // live selected-edge set + heap. INVARIANT: `live` keys and `adj`
    // entries always reference CURRENT representatives — every merge
    // rewrites the deleted vertex's incident edges.
    std::unordered_set<uint64_t> live;
    live.reserve(n_sel * 2);
    std::priority_queue<HeapEntry, std::vector<HeapEntry>, HeapCmp> heap;
    std::unordered_set<int32_t> involved;
    involved.reserve(n_sel * 2);
    std::vector<std::unordered_set<int32_t>> adj(n_verts);
    for (int64_t i = 0; i < n_sel; ++i) {
        int32_t a = sel_edges[2 * i], b = sel_edges[2 * i + 1];
        involved.insert(a);
        involved.insert(b);
        if (a == b) continue;
        uint64_t k = ekey(a, b);
        if (live.insert(k).second) {
            heap.push({edge_len(verts, a, b), a, b});
            adj[a].insert(b);
            adj[b].insert(a);
        }
    }

    int64_t num_collapse =
        (int64_t)((double)involved.size() * collapse_rate);
    int32_t done = 0;

    while (done < num_collapse && !heap.empty()) {
        HeapEntry top = heap.top();
        heap.pop();
        int32_t a = top.a, b = top.b;   // stored as representatives
        uint64_t k = ekey(a, b);
        auto it = live.find(k);
        if (it == live.end()) continue;  // edge rewritten or collapsed
        float cur = edge_len(verts, a, b);
        if (cur < top.len - 1e-12f * (1.0f + top.len)) {
            // endpoint moved since push: revalidate with the new length
            heap.push({cur, a, b});
            continue;
        }
        live.erase(it);
        adj[a].erase(b);
        adj[b].erase(a);

        // reference rule: edges are stored ascending (torch.sort /
        // np.unique canonicalization), so v1 = smaller id is kept,
        // unless already deleted
        int32_t v1 = a < b ? a : b;
        int32_t v2 = a < b ? b : a;
        if (vert_del[v1]) std::swap(v1, v2);

        parent[v2] = v1;
        vert_del[v2] = 1;
        std::memcpy(verts + 3 * v2, verts + 3 * v1, 3 * sizeof(float));
        std::memcpy(attrs + attr_dim * v2, attrs + attr_dim * v1,
                    attr_dim * sizeof(float));

        // rewrite v2's incident selected edges onto v1
        for (int32_t nb : adj[v2]) {
            live.erase(ekey(v2, nb));
            adj[nb].erase(v2);
            if (nb == v1) continue;
            if (live.insert(ekey(v1, nb)).second) {
                heap.push({edge_len(verts, v1, nb), v1, nb});
                adj[v1].insert(nb);
                adj[nb].insert(v1);
            }
        }
        adj[v2].clear();
        ++done;
    }

    // relabel faces, mark degenerate + duplicate faces
    std::unordered_set<uint64_t> seen_faces;
    seen_faces.reserve(n_faces * 2);
    std::memset(vert_keep, 0, n_verts);
    for (int64_t f = 0; f < n_faces; ++f) {
        int32_t x = find(faces[3 * f]);
        int32_t y = find(faces[3 * f + 1]);
        int32_t z = find(faces[3 * f + 2]);
        faces[3 * f] = x;
        faces[3 * f + 1] = y;
        faces[3 * f + 2] = z;
        if (x == y || y == z || x == z) {
            face_keep[f] = 0;
            continue;
        }
        int32_t s0 = x, s1 = y, s2 = z;
        if (s0 > s1) std::swap(s0, s1);
        if (s1 > s2) std::swap(s1, s2);
        if (s0 > s1) std::swap(s0, s1);
        // 21-bit packing is fine up to 2M vertices
        uint64_t fk = ((uint64_t)s0 << 42) | ((uint64_t)s1 << 21) |
                      (uint64_t)s2;
        if (!seen_faces.insert(fk).second) {
            face_keep[f] = 0;
            continue;
        }
        face_keep[f] = 1;
        vert_keep[x] = 1;
        vert_keep[y] = 1;
        vert_keep[z] = 1;
    }
    return done;
}

// Midpoint subdivision counting helper: number of unique edges among
// the selected faces (the number of new vertices).
int64_t count_unique_edges(const int32_t* faces, int64_t n_faces) {
    std::unordered_set<uint64_t> edges;
    edges.reserve(n_faces * 3 * 2);
    for (int64_t f = 0; f < n_faces; ++f) {
        int32_t a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
        edges.insert(ekey(a, b));
        edges.insert(ekey(b, c));
        edges.insert(ekey(c, a));
    }
    return (int64_t)edges.size();
}

}  // extern "C"
