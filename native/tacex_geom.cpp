// tacex_geom: native geometry runtime for tacex_tpu.
//
// C++ counterpart of the host-side geometry processing the reference keeps
// in native code (libuipc's uipc::geometry module: tetmesh construction,
// label_surface / label_triangle_orient / flip_inward_triangles — reference
// source/tacex_uipc/tacex_uipc/objects/uipc_object.py:181-187 calls into it).
// The device compute path stays in XLA; this library covers the scene-build
// runtime: structured tet meshing, boundary-face extraction with outward
// orientation, lumped mass computation, and barycentric marker binding.
// Exposed through a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: tacex_tpu.native builds it on first use, or make -C native
// (g++ -O2 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Structured box tet mesh (6-tet Kuhn subdivision per hex cell).
// points_out: (num_points * 3) floats; tets_out: (num_tets * 4) int32.
// Returns 0 on success.
int box_tet_mesh(int nx, int ny, int nz,
                 float sx, float sy, float sz,
                 float cx, float cy, float cz,
                 float* points_out, int32_t* tets_out) {
  const int npx = nx + 1, npy = ny + 1, npz = nz + 1;
  auto vid = [&](int i, int j, int k) { return (i * npy + j) * npz + k; };

  for (int i = 0; i < npx; ++i) {
    for (int j = 0; j < npy; ++j) {
      for (int k = 0; k < npz; ++k) {
        float* p = points_out + 3 * vid(i, j, k);
        p[0] = -sx / 2 + sx * i / nx + cx;
        p[1] = -sy / 2 + sy * j / ny + cy;
        p[2] = -sz / 2 + sz * k / nz + cz;
      }
    }
  }

  static const int corner[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                                   {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
  static const int kuhn[6][4] = {{0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
                                 {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6}};
  int t = 0;
  for (int i = 0; i < nx; ++i) {
    for (int j = 0; j < ny; ++j) {
      for (int k = 0; k < nz; ++k) {
        int c[8];
        for (int q = 0; q < 8; ++q)
          c[q] = vid(i + corner[q][0], j + corner[q][1], k + corner[q][2]);
        for (int q = 0; q < 6; ++q) {
          int32_t* tt = tets_out + 4 * t++;
          tt[0] = c[kuhn[q][0]];
          tt[1] = c[kuhn[q][1]];
          tt[2] = c[kuhn[q][2]];
          tt[3] = c[kuhn[q][3]];
        }
      }
    }
  }
  // orientation fix: positive volume
  for (int q = 0; q < t; ++q) {
    int32_t* tt = tets_out + 4 * q;
    const float* a = points_out + 3 * tt[0];
    const float* b = points_out + 3 * tt[1];
    const float* cc = points_out + 3 * tt[2];
    const float* d = points_out + 3 * tt[3];
    float d1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    float d2[3] = {cc[0] - a[0], cc[1] - a[1], cc[2] - a[2]};
    float d3[3] = {d[0] - a[0], d[1] - a[1], d[2] - a[2]};
    float cx_ = d1[1] * d2[2] - d1[2] * d2[1];
    float cy_ = d1[2] * d2[0] - d1[0] * d2[2];
    float cz_ = d1[0] * d2[1] - d1[1] * d2[0];
    float vol = cx_ * d3[0] + cy_ * d3[1] + cz_ * d3[2];
    if (vol < 0) std::swap(tt[1], tt[2]);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Boundary-face extraction with outward orientation.
// faces_out must have room for 4*num_tets*3 ints; returns the face count.
int extract_surface(const int32_t* tets, int num_tets,
                    const float* points, int num_points,
                    int32_t* faces_out) {
  (void)num_points;
  struct FaceRec { int32_t v[3]; int32_t owner; int count; };
  std::unordered_map<uint64_t, FaceRec> seen;
  seen.reserve(num_tets * 4);

  static const int kFace[4][3] = {{0, 2, 1}, {0, 1, 3}, {0, 3, 2}, {1, 2, 3}};
  auto key_of = [](int32_t a, int32_t b, int32_t c) {
    int32_t lo = a < b ? (a < c ? a : c) : (b < c ? b : c);
    int32_t hi = a > b ? (a > c ? a : c) : (b > c ? b : c);
    int32_t mid = (int64_t)a + b + c - lo - hi;
    return (uint64_t)lo << 42 | (uint64_t)mid << 21 | (uint64_t)hi;
  };

  for (int t = 0; t < num_tets; ++t) {
    const int32_t* tt = tets + 4 * t;
    for (int f = 0; f < 4; ++f) {
      int32_t a = tt[kFace[f][0]], b = tt[kFace[f][1]], c = tt[kFace[f][2]];
      uint64_t k = key_of(a, b, c);
      auto it = seen.find(k);
      if (it == seen.end()) {
        seen[k] = {{a, b, c}, t, 1};
      } else {
        it->second.count++;
      }
    }
  }

  int n = 0;
  for (auto& kv : seen) {
    if (kv.second.count != 1) continue;
    int32_t a = kv.second.v[0], b = kv.second.v[1], c = kv.second.v[2];
    // outward orientation: normal away from owner centroid
    const int32_t* tt = tets + 4 * kv.second.owner;
    float cen[3] = {0, 0, 0};
    for (int q = 0; q < 4; ++q)
      for (int d = 0; d < 3; ++d) cen[d] += points[3 * tt[q] + d] / 4.0f;
    const float* pa = points + 3 * a;
    const float* pb = points + 3 * b;
    const float* pc = points + 3 * c;
    float e1[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
    float e2[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
    float nx = e1[1] * e2[2] - e1[2] * e2[1];
    float ny = e1[2] * e2[0] - e1[0] * e2[2];
    float nz = e1[0] * e2[1] - e1[1] * e2[0];
    float d[3] = {pa[0] - cen[0], pa[1] - cen[1], pa[2] - cen[2]};
    bool outward = nx * d[0] + ny * d[1] + nz * d[2] > 0;
    faces_out[3 * n + 0] = a;
    faces_out[3 * n + 1] = outward ? b : c;
    faces_out[3 * n + 2] = outward ? c : b;
    ++n;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Lumped vertex masses: quarter of each incident tet's mass.
int lumped_masses(const int32_t* tets, int num_tets,
                  const float* points, int num_points,
                  float density, float* masses_out) {
  std::memset(masses_out, 0, sizeof(float) * num_points);
  for (int t = 0; t < num_tets; ++t) {
    const int32_t* tt = tets + 4 * t;
    const float* a = points + 3 * tt[0];
    const float* b = points + 3 * tt[1];
    const float* c = points + 3 * tt[2];
    const float* d = points + 3 * tt[3];
    float d1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    float d2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    float d3[3] = {d[0] - a[0], d[1] - a[1], d[2] - a[2]};
    float cx = d1[1] * d2[2] - d1[2] * d2[1];
    float cy = d1[2] * d2[0] - d1[0] * d2[2];
    float cz = d1[0] * d2[1] - d1[1] * d2[0];
    float vol = std::fabs(cx * d3[0] + cy * d3[1] + cz * d3[2]) / 6.0f;
    float m = density * vol / 4.0f;
    for (int q = 0; q < 4; ++q) masses_out[tt[q]] += m;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Barycentric binding: for each 2-D marker, find a containing triangle (xy
// projection) among candidate faces and output (tri index, w0, w1, w2).
// tri index = -1 when no triangle contains the marker.
int barycentric_bind(const float* markers_xy, int num_markers,
                     const float* points, int /*num_points*/,
                     const int32_t* tris, int num_tris,
                     int32_t* tri_idx_out, float* weights_out) {
  for (int m = 0; m < num_markers; ++m) {
    const float px = markers_xy[2 * m], py = markers_xy[2 * m + 1];
    tri_idx_out[m] = -1;
    for (int t = 0; t < num_tris; ++t) {
      const float* p0 = points + 3 * tris[3 * t + 0];
      const float* p1 = points + 3 * tris[3 * t + 1];
      const float* p2 = points + 3 * tris[3 * t + 2];
      float e1x = p1[0] - p0[0], e1y = p1[1] - p0[1];
      float e2x = p2[0] - p0[0], e2y = p2[1] - p0[1];
      float det = e1x * e2y - e1y * e2x;
      if (std::fabs(det) < 1e-18f) continue;
      float dx = px - p0[0], dy = py - p0[1];
      float w1 = (dx * e2y - dy * e2x) / det;
      float w2 = (e1x * dy - e1y * dx) / det;
      if (w1 >= -1e-9f && w2 >= -1e-9f && w1 + w2 <= 1.0f + 1e-9f) {
        tri_idx_out[m] = t;
        weights_out[3 * m + 0] = 1.0f - w1 - w2;
        weights_out[3 * m + 1] = w1;
        weights_out[3 * m + 2] = w2;
        break;
      }
    }
  }
  return 0;
}

}  // extern "C"
