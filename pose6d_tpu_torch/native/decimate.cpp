// Quadric-error-metric mesh decimation (Garland-Heckbert edge collapse),
// a copy of pose6d_tpu/native/decimate.cpp for the port.
//
// The native path of data/decimate.py (whose pure-Python version is the
// oracle). Exposed through a C ABI loaded with ctypes; built with g++ at
// first use by pose6d_tpu_torch/native/__init__.py.
#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_set>
#include <vector>

namespace {

using Quadric = std::array<double, 16>;  // row-major 4x4

inline void quadric_add(Quadric& a, const Quadric& b) {
  for (int i = 0; i < 16; ++i) a[i] += b[i];
}

inline double quadric_eval(const Quadric& q, const double* v) {
  const double h[4] = {v[0], v[1], v[2], 1.0};
  double acc = 0.0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc += h[i] * q[i * 4 + j] * h[j];
  return acc;
}

// Solve the 3x3 system A x = b from the quadric; returns false if
// near-singular.
inline bool optimal_point(const Quadric& q, double* out) {
  const double a00 = q[0], a01 = q[1], a02 = q[2];
  const double a11 = q[5], a12 = q[6], a22 = q[10];
  const double b0 = -q[3], b1 = -q[7], b2 = -q[11];
  const double det = a00 * (a11 * a22 - a12 * a12) -
                     a01 * (a01 * a22 - a12 * a02) +
                     a02 * (a01 * a12 - a11 * a02);
  double scale = std::fabs(a00) + std::fabs(a11) + std::fabs(a22);
  scale = scale * scale * scale;
  if (std::fabs(det) < 1e-10 * (scale > 0 ? scale : 1.0)) return false;
  const double i00 = (a11 * a22 - a12 * a12) / det;
  const double i01 = (a02 * a12 - a01 * a22) / det;
  const double i02 = (a01 * a12 - a02 * a11) / det;
  const double i11 = (a00 * a22 - a02 * a02) / det;
  const double i12 = (a02 * a01 - a00 * a12) / det;
  const double i22 = (a00 * a11 - a01 * a01) / det;
  out[0] = i00 * b0 + i01 * b1 + i02 * b2;
  out[1] = i01 * b0 + i11 * b1 + i12 * b2;
  out[2] = i02 * b0 + i12 * b1 + i22 * b2;
  return true;
}

struct HeapEntry {
  double cost;
  int32_t a, b;
  int64_t va_ver, vb_ver;
  double v[3];
  bool operator>(const HeapEntry& o) const { return cost > o.cost; }
};

}  // namespace

extern "C" int decimate_qem(const double* verts_in, int64_t nv,
                            const int64_t* faces_in, int64_t nf,
                            int64_t target_faces, double* out_verts,
                            int64_t* out_faces, int64_t* out_nv,
                            int64_t* out_nf) {
  std::vector<std::array<double, 3>> verts(nv);
  for (int64_t i = 0; i < nv; ++i)
    verts[i] = {verts_in[3 * i], verts_in[3 * i + 1], verts_in[3 * i + 2]};
  std::vector<std::array<int64_t, 3>> faces(nf);
  for (int64_t i = 0; i < nf; ++i)
    faces[i] = {faces_in[3 * i], faces_in[3 * i + 1], faces_in[3 * i + 2]};

  // per-vertex quadrics from face planes
  std::vector<Quadric> Q(nv);
  for (auto& q : Q) q.fill(0.0);
  for (int64_t f = 0; f < nf; ++f) {
    const auto& v0 = verts[faces[f][0]];
    const auto& v1 = verts[faces[f][1]];
    const auto& v2 = verts[faces[f][2]];
    double e1[3] = {v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2]};
    double e2[3] = {v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2]};
    double n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                   e1[2] * e2[0] - e1[0] * e2[2],
                   e1[0] * e2[1] - e1[1] * e2[0]};
    double norm = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (norm < 1e-12) continue;
    for (double& c : n) c /= norm;
    const double d = -(n[0] * v0[0] + n[1] * v0[1] + n[2] * v0[2]);
    const double p[4] = {n[0], n[1], n[2], d};
    Quadric k;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) k[i * 4 + j] = p[i] * p[j];
    for (int c = 0; c < 3; ++c) quadric_add(Q[faces[f][c]], k);
  }

  // vertex -> incident faces
  std::vector<std::vector<int64_t>> vfaces(nv);
  for (int64_t f = 0; f < nf; ++f)
    for (int c = 0; c < 3; ++c) vfaces[faces[f][c]].push_back(f);
  std::vector<char> face_alive(nf, 1);

  // union-find
  std::vector<int64_t> parent(nv);
  for (int64_t i = 0; i < nv; ++i) parent[i] = i;
  std::vector<int64_t> version(nv, 0);
  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };

  std::priority_queue<HeapEntry, std::vector<HeapEntry>,
                      std::greater<HeapEntry>> heap;
  auto push_edge = [&](int64_t a, int64_t b) {
    if (a == b) return;
    Quadric q = Q[a];
    quadric_add(q, Q[b]);
    HeapEntry e;
    if (!optimal_point(q, e.v)) {
      // best of endpoints / midpoint
      double mid[3] = {(verts[a][0] + verts[b][0]) / 2,
                       (verts[a][1] + verts[b][1]) / 2,
                       (verts[a][2] + verts[b][2]) / 2};
      const double* cands[3] = {verts[a].data(), verts[b].data(), mid};
      double best = 1e300;
      for (const double* c : cands) {
        double cost = quadric_eval(q, c);
        if (cost < best) {
          best = cost;
          std::memcpy(e.v, c, 3 * sizeof(double));
        }
      }
    }
    e.cost = quadric_eval(q, e.v);
    e.a = static_cast<int32_t>(a);
    e.b = static_cast<int32_t>(b);
    e.va_ver = version[a];
    e.vb_ver = version[b];
    heap.push(e);
  };

  {
    std::unordered_set<int64_t> seen;
    seen.reserve(nf * 3);
    for (int64_t f = 0; f < nf; ++f) {
      for (int c = 0; c < 3; ++c) {
        int64_t a = faces[f][c], b = faces[f][(c + 1) % 3];
        if (a > b) std::swap(a, b);
        if (seen.insert(a * nv + b).second) push_edge(a, b);
      }
    }
  }

  int64_t alive = nf;
  std::vector<int64_t> merged;
  std::unordered_set<int64_t> neighbors;
  while (alive > target_faces && !heap.empty()) {
    HeapEntry e = heap.top();
    heap.pop();
    int64_t a = find(e.a), b = find(e.b);
    if (a == b) continue;
    if (version[a] != e.va_ver || version[b] != e.vb_ver) continue;
    // collapse b into a
    verts[a] = {e.v[0], e.v[1], e.v[2]};
    quadric_add(Q[a], Q[b]);
    parent[b] = a;
    version[a] += 1;

    merged.clear();
    merged.insert(merged.end(), vfaces[a].begin(), vfaces[a].end());
    merged.insert(merged.end(), vfaces[b].begin(), vfaces[b].end());
    vfaces[b].clear();
    std::sort(merged.begin(), merged.end());
    merged.erase(std::unique(merged.begin(), merged.end()), merged.end());

    neighbors.clear();
    std::vector<int64_t> keep;
    keep.reserve(merged.size());
    for (int64_t f : merged) {
      if (!face_alive[f]) continue;
      auto& fv = faces[f];
      for (int c = 0; c < 3; ++c) fv[c] = find(fv[c]);
      if (fv[0] == fv[1] || fv[1] == fv[2] || fv[2] == fv[0]) {
        face_alive[f] = 0;
        --alive;
        continue;
      }
      keep.push_back(f);
      for (int c = 0; c < 3; ++c)
        if (fv[c] != a) neighbors.insert(fv[c]);
    }
    vfaces[a] = std::move(keep);
    for (int64_t nb : neighbors) push_edge(a, nb);
  }

  // compact
  std::vector<int64_t> remap(nv, -1);
  int64_t out_v = 0, out_f = 0;
  for (int64_t f = 0; f < nf; ++f) {
    if (!face_alive[f]) continue;
    int64_t fv[3];
    for (int c = 0; c < 3; ++c) {
      int64_t v = find(faces[f][c]);
      if (remap[v] < 0) {
        remap[v] = out_v;
        std::memcpy(out_verts + 3 * out_v, verts[v].data(),
                    3 * sizeof(double));
        ++out_v;
      }
      fv[c] = remap[v];
    }
    out_faces[3 * out_f] = fv[0];
    out_faces[3 * out_f + 1] = fv[1];
    out_faces[3 * out_f + 2] = fv[2];
    ++out_f;
  }
  *out_nv = out_v;
  *out_nf = out_f;
  return 0;
}
