// The per-gaussian preprocess of csrc/preprocess_fwd.cu and
// csrc/preprocess_bwd.cu: one gaussian's forward, from its raw trainable
// fields to its packed entry row, with every intermediate the backward
// needs kept in a struct, so that the backward recomputes the forward
// instead of reading saved (N,) columns.
//
// It computes what the plain path gives: GaussianParams.get_scaling /
// get_rotation / get_opacity (models/gaussian_model.py),
// core/transforms.py `covariance_from_scaling_rotation`, ops/preprocess.py
// `preprocess` and `pack_entries`, in the same formulas, constants, clamps
// and culls, and in PyTorch's order of float32 operations where PyTorch
// fixes one (each elementwise op rounds once: round-to-nearest intrinsics,
// no FMA contraction; a Python float constant is its double rounded to
// float; `a / python_scalar` on the card is `a * (1 / scalar)`, `python /
// tensor` is `reciprocal(tensor) * python`). Reductions (the two norms,
// the SH sum over coefficients) are summed in index order, which PyTorch
// does not promise, so a few ulps may differ there.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace pre {

// sh_basis's constants (core/sh.py), as float32 rounds the doubles
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kC2_0 = static_cast<float>(1.0925484305920792);
constexpr float kC2_1 = static_cast<float>(-1.0925484305920792);
constexpr float kC2_2 = static_cast<float>(0.31539156525252005);
constexpr float kC2_3 = static_cast<float>(-1.0925484305920792);
constexpr float kC2_4 = static_cast<float>(0.5462742152960396);
constexpr float kC3_0 = static_cast<float>(-0.5900435899266435);
constexpr float kC3_1 = static_cast<float>(2.890611442640554);
constexpr float kC3_2 = static_cast<float>(-0.4570457994644658);
constexpr float kC3_3 = static_cast<float>(0.3731763325901154);
constexpr float kC3_4 = static_cast<float>(-0.4570457994644658);
constexpr float kC3_5 = static_cast<float>(1.445305721320277);
constexpr float kC3_6 = static_cast<float>(-0.5900435899266435);
constexpr int kMaxCoeffs = 16;     // SH degree 3
constexpr int kRow = 16;           // floats of a packed row

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.clamp and torch.minimum: NaN in, NaN out
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

// The camera and the call's settings, the same for every gaussian.
struct Setup {
  const float* world_view;   // (4, 4) row-major, x_view = W2V x_world
  const float* full_proj;    // (4, 4)
  const float* cam_center;   // (3,)
  const float* tanfovx;      // ()
  const float* tanfovy;      // ()
  int n;                     // gaussians
  int n_coeffs;              // K = (max degree + 1)^2, at most 16
  int k_active;              // min(K, (active degree + 1)^2)
  int width, height;
  float scaling_modifier;
  bool antialiasing;
  float dilation;
  float alpha_min;
};

inline Setup make_setup(const float* world_view, const float* full_proj,
                        const float* cam_center, const float* tanfovx,
                        const float* tanfovy, int n, int n_coeffs,
                        int active_sh_degree, int width, int height,
                        float scaling_modifier, int antialiasing,
                        float dilation, float alpha_min) {
  Setup s;
  s.world_view = world_view;
  s.full_proj = full_proj;
  s.cam_center = cam_center;
  s.tanfovx = tanfovx;
  s.tanfovy = tanfovy;
  s.n = n;
  s.n_coeffs = n_coeffs;
  const int deg = active_sh_degree < 0 ? 0 : active_sh_degree;
  s.k_active = (deg + 1) * (deg + 1) < n_coeffs ? (deg + 1) * (deg + 1)
                                                : n_coeffs;
  s.width = width;
  s.height = height;
  s.scaling_modifier = scaling_modifier;
  s.antialiasing = antialiasing != 0;
  s.dilation = dilation;
  s.alpha_min = alpha_min;
  return s;
}

// The camera's derived constants as ops/preprocess.py forms them.
struct Cam {
  float wv[12];              // rows 0..2 of world_view
  float fp[16];
  float cc[3];
  float fx, fy, limx, limy;
};

__device__ __forceinline__ Cam load_cam(const Setup& s) {
  Cam c;
#pragma unroll
  for (int k = 0; k < 12; ++k) c.wv[k] = s.world_view[k];
#pragma unroll
  for (int k = 0; k < 16; ++k) c.fp[k] = s.full_proj[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) c.cc[k] = s.cam_center[k];
  const float tx = *s.tanfovx, ty = *s.tanfovy;
  // W / (2.0 * tanfovx): reciprocal, then times W
  c.fx = mul(dvd(1.f, mul(2.f, tx)), static_cast<float>(s.width));
  c.fy = mul(dvd(1.f, mul(2.f, ty)), static_cast<float>(s.height));
  c.limx = mul(static_cast<float>(1.3), tx);
  c.limy = mul(static_cast<float>(1.3), ty);
  return c;
}

// Row i of a 4x4 matrix applied to (x, y, z, 1), left to right.
__device__ __forceinline__ float apply_row(const float* m, const float* p) {
  return add(add(add(mul(m[0], p[0]), mul(m[1], p[1])), mul(m[2], p[2])),
             m[3]);
}

// The real SH basis (core/sh.py sh_basis) of the unit direction d, its
// first `k` entries.
__device__ __forceinline__ void sh_basis(const float* d, int k, float* b) {
  const float x = d[0], y = d[1], z = d[2];
  b[0] = kC0;
  if (k > 1) {
    b[1] = mul(-kC1, y);
    b[2] = mul(kC1, z);
    b[3] = mul(-kC1, x);
  }
  if (k > 4) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    b[4] = mul(kC2_0, xy);
    b[5] = mul(kC2_1, yz);
    b[6] = mul(kC2_2, sub(sub(mul(2.f, zz), xx), yy));
    b[7] = mul(kC2_3, xz);
    b[8] = mul(kC2_4, sub(xx, yy));
    if (k > 9) {
      b[9] = mul(mul(kC3_0, y), sub(mul(3.f, xx), yy));
      b[10] = mul(mul(kC3_1, xy), z);
      b[11] = mul(mul(kC3_2, y), sub(sub(mul(4.f, zz), xx), yy));
      b[12] = mul(mul(kC3_3, z),
                  sub(sub(mul(2.f, zz), mul(3.f, xx)), mul(3.f, yy)));
      b[13] = mul(mul(kC3_4, x), sub(sub(mul(4.f, zz), xx), yy));
      b[14] = mul(mul(kC3_5, z), sub(xx, yy));
      b[15] = mul(mul(kC3_6, x), sub(xx, mul(3.f, yy)));
    }
  }
}

// One gaussian's forward and its intermediates.
struct Fwd {
  // activations and the 3-D covariance
  float s[3];          // exp(log scale)
  float qn;            // |q|
  float r[4];          // q / |q|        (get_rotation)
  float rn;            // |r|
  float u[4];          // r / |r|        (quat_to_rotmat's normalisation)
  float R[9];
  float ms[3];         // scaling_modifier * s
  float s2[3];         // ms^2
  float cov[6];        // xx xy xz yy yz zz
  float op;            // sigmoid(logit)
  // projection and EWA
  float xyz[3];
  float ph[4], pw, pv[3];
  float safe_tz, qx, qy, txtz, tytz, tx, ty, inv_tz, a0, a2x, b1, b2y;
  float m0[3], m1[3], s0[3], s1[3];
  float c00o, c01, c11o, det_orig, c00, c11, det, safe_det, inv_det;
  float ratio, h, op_eff;
  // view direction and colour
  bool nz;
  float v[3], norm, d[3];
  float basis[kMaxCoeffs];
  float col[3];        // before the clamp at 0
  float inv_depth;
  // the outputs that binning reads
  float mx, my, radius, rx, ry, t_cut;
  bool visible;
};

// `count` floats from src to dst by every thread of the block, neighbours
// on neighbouring words: how the backward's block writes its gaussians'
// f_rest gradient rows (K-1, 3) from shared memory to device memory. A
// thread writes its own row there at a stride of 3 (K-1) words, which for
// K = 16 (45) and K = 4 (9) is odd, so free of bank conflicts.
__device__ __forceinline__ void copy_block(const float* __restrict__ src,
                                           float* __restrict__ dst,
                                           int count) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) dst[j] = src[j];
}

// The forward of gaussian i. `f_dc` (N, 3); `rest` the gaussian's f_rest
// row, 3 (K-1) floats.
__device__ __forceinline__ void forward(
    const Setup& st, const Cam& cam, int i, const float* __restrict__ xyz,
    const float* __restrict__ scaling, const float* __restrict__ rotation,
    const float* __restrict__ opacity, const float* __restrict__ f_dc,
    const float* rest, const unsigned char* __restrict__ active, Fwd& f) {
  const long long i3 = 3LL * i;
  // --- activations ---
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.xyz[k] = xyz[i3 + k];
    f.s[k] = expf(scaling[i3 + k]);
  }
  float q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = rotation[4LL * i + k];
  f.qn = sqrtf(add(add(add(mul(q[0], q[0]), mul(q[1], q[1])),
                       mul(q[2], q[2])), mul(q[3], q[3])));
#pragma unroll
  for (int k = 0; k < 4; ++k) f.r[k] = dvd(q[k], f.qn);
  f.rn = sqrtf(add(add(add(mul(f.r[0], f.r[0]), mul(f.r[1], f.r[1])),
                       mul(f.r[2], f.r[2])), mul(f.r[3], f.r[3])));
#pragma unroll
  for (int k = 0; k < 4; ++k) f.u[k] = dvd(f.r[k], f.rn);
  f.op = dvd(1.f, add(1.f, expf(-opacity[i])));

  // --- Σ = R diag(s²) Rᵀ, symmetric-6 ---
  {
    const float w = f.u[0], x = f.u[1], y = f.u[2], z = f.u[3];
    f.R[0] = sub(1.f, mul(2.f, add(mul(y, y), mul(z, z))));
    f.R[1] = mul(2.f, sub(mul(x, y), mul(w, z)));
    f.R[2] = mul(2.f, add(mul(x, z), mul(w, y)));
    f.R[3] = mul(2.f, add(mul(x, y), mul(w, z)));
    f.R[4] = sub(1.f, mul(2.f, add(mul(x, x), mul(z, z))));
    f.R[5] = mul(2.f, sub(mul(y, z), mul(w, x)));
    f.R[6] = mul(2.f, sub(mul(x, z), mul(w, y)));
    f.R[7] = mul(2.f, add(mul(y, z), mul(w, x)));
    f.R[8] = sub(1.f, mul(2.f, add(mul(x, x), mul(y, y))));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.ms[k] = mul(st.scaling_modifier, f.s[k]);
    f.s2[k] = mul(f.ms[k], f.ms[k]);
  }
  {
    const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const float* Ri = f.R + 3 * I[e];
      const float* Rj = f.R + 3 * J[e];
      f.cov[e] = add(add(mul(mul(f.s2[0], Ri[0]), Rj[0]),
                         mul(mul(f.s2[1], Ri[1]), Rj[1])),
                     mul(mul(f.s2[2], Ri[2]), Rj[2]));
    }
  }

  // --- projection ---
  f.ph[0] = apply_row(cam.fp, f.xyz);
  f.ph[1] = apply_row(cam.fp + 4, f.xyz);
  f.ph[2] = apply_row(cam.fp + 8, f.xyz);
  f.ph[3] = apply_row(cam.fp + 12, f.xyz);
  f.pw = dvd(1.f, add(f.ph[3], static_cast<float>(1e-7)));
#pragma unroll
  for (int k = 0; k < 3; ++k) f.pv[k] = apply_row(cam.wv + 4 * k, f.xyz);
  const float W = static_cast<float>(st.width);
  const float H = static_cast<float>(st.height);
  f.mx = mul(sub(mul(add(mul(f.ph[0], f.pw), 1.f), W), 1.f), 0.5f);
  f.my = mul(sub(mul(add(mul(f.ph[1], f.pw), 1.f), H), 1.f), 0.5f);

  // --- EWA 2-D covariance, J with the 1.3 tanfov clamp ---
  const float tz = f.pv[2];
  f.safe_tz = fabsf(tz) < static_cast<float>(1e-6) ? static_cast<float>(1e-6)
                                                    : tz;
  f.qx = dvd(f.pv[0], f.safe_tz);
  f.qy = dvd(f.pv[1], f.safe_tz);
  f.txtz = clamp(f.qx, -cam.limx, cam.limx);
  f.tytz = clamp(f.qy, -cam.limy, cam.limy);
  f.tx = mul(f.txtz, tz);
  f.ty = mul(f.tytz, tz);
  f.inv_tz = dvd(1.f, f.safe_tz);
  f.a0 = mul(cam.fx, f.inv_tz);
  f.a2x = mul(mul(mul(-cam.fx, f.tx), f.inv_tz), f.inv_tz);
  f.b1 = mul(cam.fy, f.inv_tz);
  f.b2y = mul(mul(mul(-cam.fy, f.ty), f.inv_tz), f.inv_tz);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.m0[k] = add(mul(f.a0, cam.wv[k]), mul(f.a2x, cam.wv[8 + k]));
    f.m1[k] = add(mul(f.b1, cam.wv[4 + k]), mul(f.b2y, cam.wv[8 + k]));
  }
  {
    const float* c = f.cov;   // Σ m, the rows xx xy xz / xy yy yz / xz yz zz
    const float S[9] = {c[0], c[1], c[2], c[1], c[3], c[4], c[2], c[4], c[5]};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      f.s0[a] = dot3(S + 3 * a, f.m0);
      f.s1[a] = dot3(S + 3 * a, f.m1);
    }
  }
  f.c00o = dot3(f.m0, f.s0);
  f.c01 = dot3(f.m0, f.s1);
  f.c11o = dot3(f.m1, f.s1);
  f.det_orig = sub(mul(f.c00o, f.c11o), mul(f.c01, f.c01));
  f.c00 = add(f.c00o, st.dilation);
  f.c11 = add(f.c11o, st.dilation);
  f.det = sub(mul(f.c00, f.c11), mul(f.c01, f.c01));
  f.safe_det = f.det == 0.f ? 1.f : f.det;
  f.inv_det = dvd(1.f, f.safe_det);

  const float mid = mul(0.5f, add(f.c00, f.c11));
  const float lam = add(mid, sqrtf(clamp_min(sub(mul(mid, mid), f.det),
                                             static_cast<float>(0.1))));
  const float radius = ceilf(mul(3.f, sqrtf(clamp_min(lam, 0.f))));

  if (st.antialiasing) {
    f.ratio = dvd(f.det_orig, f.safe_det);
    f.h = sqrtf(clamp_min(f.ratio, static_cast<float>(2.5e-5)));
    f.op_eff = mul(f.op, f.h);
  } else {
    f.ratio = 0.f;
    f.h = 1.f;
    f.op_eff = f.op;
  }

  // the level-set threshold and the tight binning extents
  const float inv_amin = dvd(1.f, st.alpha_min);
  const float t_cut = clamp_min(
      add(mul(2.f, logf(mul(clamp_min(f.op_eff, static_cast<float>(1e-12)),
                            inv_amin))),
          static_cast<float>(1e-3)),
      0.f);
  const float rx = minimum(ceilf(sqrtf(mul(t_cut, clamp_min(f.c00, 0.f)))),
                           radius);
  const float ry = minimum(ceilf(sqrtf(mul(t_cut, clamp_min(f.c11, 0.f)))),
                           radius);

  // --- SH -> RGB, clamped at 0, to the active degree ---
#pragma unroll
  for (int k = 0; k < 3; ++k) f.v[k] = sub(f.xyz[k], cam.cc[k]);
  f.nz = dot3(f.v, f.v) > 0.f;
  float sv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) sv[k] = f.nz ? f.v[k] : 1.f;
  f.norm = sqrtf(dot3(sv, sv));
#pragma unroll
  for (int k = 0; k < 3; ++k) f.d[k] = f.nz ? dvd(sv[k], f.norm) : 0.f;
  const int ka = st.k_active;
  sh_basis(f.d, ka, f.basis);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = mul(f_dc[i3 + c], f.basis[0]);
#pragma unroll
    for (int k = 1; k < kMaxCoeffs; ++k)
      if (k < ka) acc = add(acc, mul(rest[3 * (k - 1) + c], f.basis[k]));
    f.col[c] = add(acc, 0.5f);
  }

  // --- visibility: z-cull at 0.2, det cull, dead slots ---
  const float depth = tz;
  f.visible = depth > static_cast<float>(0.2) && f.det > 0.f &&
              active[i] != 0;
  const bool tight = f.visible && t_cut > 0.f;
  f.radius = f.visible ? radius : 0.f;
  f.rx = tight ? rx : 0.f;
  f.ry = tight ? ry : 0.f;
  f.t_cut = tight ? t_cut : 0.f;
  const float safe_depth = depth == 0.f ? 1.f : depth;
  f.inv_depth = depth > static_cast<float>(0.2) ? dvd(1.f, safe_depth) : 0.f;
}

}  // namespace pre
