// Native data-pipeline kernels for the skeleton preprocessing hot loops.
//
// The reference's CPU dataloader spends most of its time in PreNormalize3D's
// per-sample Python loops (reference pyskl/datasets/pipelines/pose_related.py
// :286-336).  This implements the same semantics in C++
// behind a plain C ABI consumed via ctypes (no pybind11 in the image).
//
// Exact behaviors mirrored:
//   * empty-frame detection with np.isclose(x, 0) default tolerance (|x|<=1e-8)
//   * denser-body primary selection with body swap (pose_related.py:297-306)
//   * centering on joint 1 (V==25) or the last joint, masked by nonzero joints
//   * spine->z and shoulder->x Rodrigues alignment (pose_related.py:318-331)
//
// Built at first use by dsgcn_tpu_torch/data/native.py:
//   g++ -O3 -shared -fPIC skel_ops.cpp -o libskel_ops-<hash>.so

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr float kCloseTol = 1e-8f;   // np.isclose(x, 0) default atol

inline bool frame_empty(const float* kp, int V, int C) {
  for (int i = 0; i < V * C; ++i) {
    if (std::fabs(kp[i]) > kCloseTol) return false;
  }
  return true;
}

// Rodrigues rotation matrix about `axis` by `theta` (pose_related.py:265-278).
void rotation_matrix(const double axis_in[3], double theta, double R[9]) {
  double asum = std::fabs(axis_in[0]) + std::fabs(axis_in[1]) +
                std::fabs(axis_in[2]);
  if (asum < 1e-6 || std::fabs(theta) < 1e-6) {
    R[0] = 1; R[1] = 0; R[2] = 0;
    R[3] = 0; R[4] = 1; R[5] = 0;
    R[6] = 0; R[7] = 0; R[8] = 1;
    return;
  }
  double n = std::sqrt(axis_in[0] * axis_in[0] + axis_in[1] * axis_in[1] +
                       axis_in[2] * axis_in[2]);
  double a = std::cos(theta / 2.0);
  double b = -axis_in[0] / n * std::sin(theta / 2.0);
  double c = -axis_in[1] / n * std::sin(theta / 2.0);
  double d = -axis_in[2] / n * std::sin(theta / 2.0);
  double aa = a * a, bb = b * b, cc = c * c, dd = d * d;
  double bc = b * c, ad = a * d, ac = a * c, ab = a * b, bd = b * d,
         cd = c * d;
  R[0] = aa + bb - cc - dd; R[1] = 2 * (bc + ad); R[2] = 2 * (bd - ac);
  R[3] = 2 * (bc - ad); R[4] = aa + cc - bb - dd; R[5] = 2 * (cd + ab);
  R[6] = 2 * (bd + ac); R[7] = 2 * (cd - ab); R[8] = aa + dd - bb - cc;
}

double angle_between(const double v1[3], const double v2[3]) {
  double s1 = std::fabs(v1[0]) + std::fabs(v1[1]) + std::fabs(v1[2]);
  double s2 = std::fabs(v2[0]) + std::fabs(v2[1]) + std::fabs(v2[2]);
  if (s1 < 1e-6 || s2 < 1e-6) return 0.0;
  double n1 = std::sqrt(v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2]);
  double n2 = std::sqrt(v2[0] * v2[0] + v2[1] * v2[1] + v2[2] * v2[2]);
  double dot = (v1[0] * v2[0] + v1[1] * v2[1] + v1[2] * v2[2]) / (n1 * n2);
  if (dot > 1.0) dot = 1.0;
  if (dot < -1.0) dot = -1.0;
  return std::acos(dot);
}

void cross3(const double a[3], const double b[3], double out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// apply skeleton = skeleton @ R^T elementwise: out = einsum('...d,kd->...k')
void apply_rotation(float* kp, int64_t count, const double R[9]) {
  for (int64_t i = 0; i < count; ++i) {
    float* p = kp + i * 3;
    double x = p[0], y = p[1], z = p[2];
    p[0] = static_cast<float>(R[0] * x + R[1] * y + R[2] * z);
    p[1] = static_cast<float>(R[3] * x + R[4] * y + R[5] * z);
    p[2] = static_cast<float>(R[6] * x + R[7] * y + R[8] * z);
  }
}

}  // namespace

extern "C" {

// In/out:
//   kp:   (M, T, V, 3) float32, C-contiguous (modified in place up to T_new)
//   out:  (M, T, V, 3) float32 destination (only first T_new frames valid)
//   body_center: float[3] output
// Returns T_new (number of kept frames), or -1 on unsupported input.
int prenormalize3d(const float* kp, int M, int T, int V,
                   int align_spine, int align_center,
                   int zaxis0, int zaxis1, int xaxis0, int xaxis1,
                   float* out, float* body_center) {
  if (M < 1 || M > 2) return -1;
  const int C = 3;
  const int64_t frame = static_cast<int64_t>(V) * C;
  const int64_t body = static_cast<int64_t>(T) * frame;

  // all-zero input: copy through (pose_related.py:292-293)
  bool all_zero = true;
  for (int64_t i = 0; i < M * body && all_zero; ++i) {
    if (kp[i] != 0.0f) all_zero = false;
  }
  if (all_zero) {
    std::memcpy(out, kp, sizeof(float) * M * body);
    body_center[0] = body_center[1] = body_center[2] = 0.0f;
    return T;
  }

  // nonempty frame indices per body
  int n0 = 0, n1 = 0;
  int* idx0 = new int[T];
  int* idx1 = new int[T];
  for (int t = 0; t < T; ++t) {
    if (!frame_empty(kp + 0 * body + t * frame, V, C)) idx0[n0++] = t;
  }
  bool swap = false;
  const int* keep = idx0;
  int T_new = n0;
  if (M == 2) {
    for (int t = 0; t < T; ++t) {
      if (!frame_empty(kp + 1 * body + t * frame, V, C)) idx1[n1++] = t;
    }
    if (n0 < n1) {      // body 1 denser: keep its frames, swap bodies
      swap = true;
      keep = idx1;
      T_new = n1;
    }
  }

  // gather frames (with optional body swap)
  for (int m = 0; m < M; ++m) {
    int src_m = swap ? (1 - m) : m;
    for (int t = 0; t < T_new; ++t) {
      std::memcpy(out + m * body + static_cast<int64_t>(t) * frame,
                  kp + src_m * body + static_cast<int64_t>(keep[t]) * frame,
                  sizeof(float) * frame);
    }
  }
  delete[] idx0;
  delete[] idx1;

  // center on the main body's reference joint at frame 0
  float cx = 0, cy = 0, cz = 0;
  if (align_center) {
    int cj = (V == 25) ? 1 : (V - 1);
    const float* cp = out + 0 * body + 0 * frame + cj * C;
    cx = cp[0]; cy = cp[1]; cz = cp[2];
    for (int m = 0; m < M; ++m) {
      for (int t = 0; t < T_new; ++t) {
        float* f = out + m * body + static_cast<int64_t>(t) * frame;
        for (int v = 0; v < V; ++v) {
          float* p = f + v * C;
          // mask: joints with any nonzero coord (pose_related.py:315)
          if (p[0] != 0.0f || p[1] != 0.0f || p[2] != 0.0f) {
            p[0] -= cx; p[1] -= cy; p[2] -= cz;
          } else {
            p[0] = 0; p[1] = 0; p[2] = 0;
          }
        }
      }
    }
  }
  body_center[0] = cx; body_center[1] = cy; body_center[2] = cz;

  if (align_spine) {
    const float* f0 = out;  // body 0, frame 0
    // spine -> z
    double bot[3] = {f0[zaxis0 * C], f0[zaxis0 * C + 1], f0[zaxis0 * C + 2]};
    double top[3] = {f0[zaxis1 * C], f0[zaxis1 * C + 1], f0[zaxis1 * C + 2]};
    double spine[3] = {top[0] - bot[0], top[1] - bot[1], top[2] - bot[2]};
    double zaxis[3] = {0, 0, 1};
    double axis[3], R[9];
    cross3(spine, zaxis, axis);
    rotation_matrix(axis, angle_between(spine, zaxis), R);
    for (int m = 0; m < M; ++m) {
      apply_rotation(out + m * body, static_cast<int64_t>(T_new) * V, R);
    }
    // shoulders -> x (recomputed after the first rotation)
    double rs[3] = {f0[xaxis0 * C], f0[xaxis0 * C + 1], f0[xaxis0 * C + 2]};
    double ls[3] = {f0[xaxis1 * C], f0[xaxis1 * C + 1], f0[xaxis1 * C + 2]};
    double sh[3] = {rs[0] - ls[0], rs[1] - ls[1], rs[2] - ls[2]};
    double xax[3] = {1, 0, 0};
    cross3(sh, xax, axis);
    rotation_matrix(axis, angle_between(sh, xax), R);
    for (int m = 0; m < M; ++m) {
      apply_rotation(out + m * body, static_cast<int64_t>(T_new) * V, R);
    }
  }
  return T_new;
}

// bone features: bone[..., v1, :] = kp[..., v1, :] - kp[..., v2, :]
void joint_to_bone(const float* kp, int M, int T, int V, int C,
                   const int* pairs, int n_pairs, float* out) {
  const int64_t frame = static_cast<int64_t>(V) * C;
  const int64_t total = static_cast<int64_t>(M) * T;
  std::memset(out, 0, sizeof(float) * total * frame);
  for (int64_t i = 0; i < total; ++i) {
    const float* f = kp + i * frame;
    float* o = out + i * frame;
    for (int p = 0; p < n_pairs; ++p) {
      int v1 = pairs[2 * p], v2 = pairs[2 * p + 1];
      for (int c = 0; c < C; ++c) {
        o[v1 * C + c] = f[v1 * C + c] - f[v2 * C + c];
      }
    }
  }
}

}  // extern "C"
