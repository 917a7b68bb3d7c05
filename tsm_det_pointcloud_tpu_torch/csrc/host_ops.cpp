// Host-side ops of the data pipeline and the offline KITTI eval: rotated
// 2D IoU (the official eval's overlaps) and point-in-box tests (gt-database
// creation, the augmentors). The port's own copy of the JAX package's
// csrc/host_ops.cpp, unchanged in what it computes: an OpenMP-parallel C++
// library built by g++ at first use and loaded with ctypes
// (ops/host_native.py). The numpy bodies eval/rotate_iou_np.py
// `_rotate_iou_numpy` and ops/boxes.py `points_in_boxes_np_plain` are its
// plain versions, which the tests hold it against. Beside them, and not in
// the JAX library: CRC32C of the Waymo tfrecord framing (the JAX
// waymo_preprocess.py computes it a byte at a time in Python, over frames of
// megabytes; datasets/waymo/waymo_preprocess.py `crc32c_plain` is that body).
//
// Numerics mirror eval/rotate_iou_np.py: the same corner order, the same
// >= -1e-9 inside test and |denom| > 1e-12 guard in Sutherland-Hodgman
// clipping, shoelace |area| / 2, so the library and the numpy body agree to
// float32 round-off.

#include <cmath>
#include <cstdint>

namespace {

struct Pt {
  double x, y;
};

// (cx, cy, w, h, angle) -> 4 corners, same order as rotate_iou_np._corners
inline void corners(const double* b, Pt* c) {
  const double cx = b[0], cy = b[1], w = b[2], h = b[3], a = b[4];
  const double ca = std::cos(a), sa = std::sin(a);
  const double dx[4] = {w / 2, w / 2, -w / 2, -w / 2};
  const double dy[4] = {-h / 2, h / 2, h / 2, -h / 2};
  for (int i = 0; i < 4; ++i) {
    c[i].x = cx + dx[i] * ca - dy[i] * sa;
    c[i].y = cy + dx[i] * sa + dy[i] * ca;
  }
}

// Clip polygon (poly, n) by the half-plane left of edge a->b (CCW clip
// quad). Same emission rule as rotate_iou_np._clip_edge: each vertex
// emits itself if inside, then the crossing point if the edge to the
// next vertex changes sides.
inline int clip_edge(const Pt* poly, int n, Pt a, Pt b, Pt* out) {
  const double ex = b.x - a.x, ey = b.y - a.y;
  double side[16];
  for (int i = 0; i < n; ++i) {
    side[i] = ex * (poly[i].y - a.y) - ey * (poly[i].x - a.x);
  }
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1) % n;
    const bool in_i = side[i] >= -1e-9;
    const bool in_j = side[j] >= -1e-9;
    if (in_i) out[m++] = poly[i];
    if (in_i != in_j) {
      const double denom = side[i] - side[j];
      const double t = std::fabs(denom) > 1e-12 ? side[i] / denom : 0.0;
      out[m].x = poly[i].x + (poly[j].x - poly[i].x) * t;
      out[m].y = poly[i].y + (poly[j].y - poly[i].y) * t;
      ++m;
    }
  }
  return m;
}

inline double poly_area(const Pt* p, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1) % n;
    s += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return 0.5 * std::fabs(s);
}

inline double quad_intersection(const Pt* ca, const Pt* cb) {
  Pt buf_a[16], buf_b[16];
  for (int i = 0; i < 4; ++i) buf_a[i] = ca[i];
  int n = 4;
  Pt* cur = buf_a;
  Pt* nxt = buf_b;
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_edge(cur, n, cb[e], cb[(e + 1) % 4], nxt);
    Pt* t = cur;
    cur = nxt;
    nxt = t;
  }
  return n > 0 ? poly_area(cur, n) : 0.0;
}

// CRC32C (Castagnoli, reflected polynomial 0x82F63B78), slicing by 8:
// table[k][b] is the CRC of byte b followed by k zero bytes
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (int i = 0; i < 256; ++i) t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const Crc32cTables kCrc;

}  // namespace

extern "C" {

// CRC32C of data (n bytes) continuing from crc (0 to start), as
// waymo_preprocess.crc32c: pre- and post-inverted.
uint32_t tsm_crc32c(const uint8_t* data, int64_t n, uint32_t crc) {
  crc = ~crc;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    const uint32_t lo = crc ^ (uint32_t(data[i]) | uint32_t(data[i + 1]) << 8 |
                               uint32_t(data[i + 2]) << 16 | uint32_t(data[i + 3]) << 24);
    const uint32_t hi = uint32_t(data[i + 4]) | uint32_t(data[i + 5]) << 8 |
                        uint32_t(data[i + 6]) << 16 | uint32_t(data[i + 7]) << 24;
    crc = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^ kCrc.t[5][(lo >> 16) & 0xFF] ^
          kCrc.t[4][lo >> 24] ^ kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
          kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
  }
  for (; i < n; ++i) crc = kCrc.t[0][(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// boxes_a (N, 5), boxes_b (M, 5) float64; out (N, M) float32.
// criterion: -2 raw intersection area, -1 IoU, 0 inter/area_a,
// 1 inter/area_b (the eval/rotate_iou_np.py contract).
void tsm_rotate_iou(const double* boxes_a, int64_t n, const double* boxes_b,
                    int64_t m, int criterion, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    Pt ca[4];
    corners(boxes_a + i * 5, ca);
    const double area_a = boxes_a[i * 5 + 2] * boxes_a[i * 5 + 3];
    for (int64_t j = 0; j < m; ++j) {
      Pt cb[4];
      corners(boxes_b + j * 5, cb);
      const double inter = quad_intersection(ca, cb);
      double v;
      if (criterion == -2) {
        v = inter;
      } else {
        const double area_b = boxes_b[j * 5 + 2] * boxes_b[j * 5 + 3];
        double denom;
        if (criterion == -1)
          denom = area_a + area_b - inter;
        else if (criterion == 0)
          denom = area_a;
        else
          denom = area_b;
        v = inter / (denom > 1e-9 ? denom : 1e-9);
      }
      out[i * m + j] = static_cast<float>(v);
    }
  }
}

// points (N, 3) float64, boxes (M, 7) float64 (cx, cy, cz, dx, dy, dz,
// heading). out (N,) int64 = index of the FIRST containing box, else -1
// (ops/boxes.py::points_in_boxes_np contract: inclusive |local| <= d/2).
void tsm_points_in_boxes(const double* points, int64_t n,
                         const double* boxes, int64_t m, int64_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double px = points[i * 3], py = points[i * 3 + 1],
                 pz = points[i * 3 + 2];
    int64_t hit = -1;
    for (int64_t j = 0; j < m; ++j) {
      const double* b = boxes + j * 7;
      const double rx = px - b[0], ry = py - b[1], rz = pz - b[2];
      // rotate by -heading (mirrors the numpy cos(-a)/sin(-a) formula)
      const double ca = std::cos(-b[6]), sa = std::sin(-b[6]);
      const double lx = rx * ca - ry * sa;
      const double ly = rx * sa + ry * ca;
      if (std::fabs(lx) <= b[3] * 0.5 && std::fabs(ly) <= b[4] * 0.5 &&
          std::fabs(rz) <= b[5] * 0.5) {
        hit = j;
        break;
      }
    }
    out[i] = hit;
  }
}

}  // extern "C"
