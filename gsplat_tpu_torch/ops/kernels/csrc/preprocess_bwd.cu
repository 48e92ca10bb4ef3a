// Backward of the fused per-gaussian preprocess (csrc/preprocess_fwd.cu)
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates this stage with
// XLA. It computes what autograd gives through the plain path
// (GaussianParams.get_*, ops/preprocess.py `preprocess`, `pack_entries` and
// the tap of ops/rasterize.py `build_entries`): from d packed (N+1, 16) the
// gradients of the raw fields xyz, log scaling, rotation, logit opacity,
// f_dc, f_rest and of the tap (d columns 0-1 times (W/2, H/2)). Only
// columns 0-9 carry a gradient: radius, rx, ry, t_cut and depth go to
// binning through ceil or detached, so autograd never reaches them.
//
// The derivative has the structure of the reference rasterizer's
// `preprocessCUDA` backward (diff-gaussian-rasterization: the 2-D
// covariance backward of `computeCov2DCUDA`, the SH colour backward, the
// scale and rotation to 3-D covariance backward), extended by this port's
// own terms: the activations (exp, both quaternion normalisations, sigmoid),
// the dilation, the antialiasing factor, invdepth, the colour's clamp at 0
// and the tanfov clamp. Autograd's conventions hold: a clamp passes the
// gradient at its boundary (inclusive), a `torch.where` only to the branch
// it took; a culled or dead gaussian still gets the gradient of the columns
// it wrote.
//
// What bounds it on this card: bytes. Per gaussian it reads the raw fields
// (237 B at SH degree 3) and 40 B of d packed, and writes 236 B of
// gradients (59 floats) and the tap's 8 B: 0.52 GB + 0.73 GB at N = 3M,
// about 0.37 ms at 3.35 TB/s, against about 900 float32 operations (0.04
// ms at 67 TFLOP/s).
//
// What the design does about it: one thread a gaussian recomputes the
// forward's intermediates in registers from the raw fields (the forward
// saves nothing of size N) and writes each gradient once. Each thread
// writes its f_rest row's gradient into shared memory, and the block writes
// its rows out at consecutive words: the largest gradient (180 of the 236
// bytes) leaves in whole sectors, not as 4-byte pieces 180 bytes apart. A
// thread reads its own f_rest row from device memory, as the forward does
// (the L1 serves a warp's rows from whole lines). Each thread owns its gaussian's rows, so there are no atomics and
// the result is the same bits on every run.

#include <cuda_runtime.h>

#include "preprocess.cuh"

namespace {

using namespace pre;

constexpr int kThreads = 128;

// d (r / |r|) -> d r: (du - u (u . du)) / |r|, u = r / |r|
__device__ __forceinline__ void normalize_bwd4(const float* u, float n,
                                               const float* du, float* dr) {
  const float dot = u[0] * du[0] + u[1] * du[1] + u[2] * du[2] + u[3] * du[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) dr[k] = (du[k] - u[k] * dot) / n;
}

// The backward of gaussian i. `rest` is its f_rest row (3 (K-1) floats);
// the row's gradient goes to `d_rest`.
__device__ __forceinline__ void backward(
    const Setup& st, int i, const float* __restrict__ xyz,
    const float* __restrict__ scaling, const float* __restrict__ rotation,
    const float* __restrict__ opacity, const float* __restrict__ f_dc,
    const float* __restrict__ rest, float* d_rest,
    const unsigned char* __restrict__ active,
    const float* __restrict__ d_packed, float* __restrict__ d_xyz,
    float* __restrict__ d_scaling, float* __restrict__ d_rotation,
    float* __restrict__ d_opacity, float* __restrict__ d_f_dc,
    float* __restrict__ d_tap) {
  const Cam cam = load_cam(st);
  Fwd f;
  forward(st, cam, i, xyz, scaling, rotation, opacity, f_dc, rest, active,
          f);
  const long long i3 = 3LL * i;
  const float4* drow = reinterpret_cast<const float4*>(
      d_packed + static_cast<long long>(i) * kRow);
  const float4 g0 = drow[0], g1 = drow[1], g2 = drow[2];
  const float g[10] = {g0.x, g0.y, g0.z, g0.w, g1.x,
                       g1.y, g1.z, g1.w, g2.x, g2.y};
  const float W = static_cast<float>(st.width);
  const float H = static_cast<float>(st.height);
  if (d_tap) {
    d_tap[2LL * i] = g[0] * static_cast<float>(0.5 * st.width);
    d_tap[2LL * i + 1] = g[1] * static_cast<float>(0.5 * st.height);
  }
  float dxyz[3] = {0.f, 0.f, 0.f};

  // --- columns 0-1: ((ph / (ph3 + 1e-7) + 1) * W - 1) / 2 ---
  const float dvx = (g[0] * 0.5f) * W;
  const float dvy = (g[1] * 0.5f) * H;
  const float dpw = dvx * f.ph[0] + dvy * f.ph[1];
  const float dph0 = dvx * f.pw, dph1 = dvy * f.pw;
  const float dph3 = -dpw * (f.pw * f.pw);

  // --- columns 6-8: SH colour, clamped at 0, to the active degree ---
  const int ka = st.k_active;
  float gc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) gc[c] = f.col[c] >= 0.f ? g[6 + c] : 0.f;
  float db[kMaxCoeffs];
#pragma unroll
  for (int c = 0; c < 3; ++c) d_f_dc[i3 + c] = gc[c] * f.basis[0];
  db[0] = 0.f;
#pragma unroll
  for (int k = 1; k < kMaxCoeffs; ++k) {
    if (k >= st.n_coeffs) break;
    const float* at = rest + 3 * (k - 1);
    float* d_at = d_rest + 3 * (k - 1);
    if (k < ka) {
      db[k] = gc[0] * at[0] + gc[1] * at[1] + gc[2] * at[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) d_at[c] = gc[c] * f.basis[k];
    } else {
      db[k] = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) d_at[c] = 0.f;
    }
  }
  float dd[3] = {0.f, 0.f, 0.f};     // d of the unit view direction
  if (ka > 1) {
    dd[0] += -kC1 * db[3];
    dd[1] += -kC1 * db[1];
    dd[2] += kC1 * db[2];
  }
  if (ka > 4) {
    const float x = f.d[0], y = f.d[1], z = f.d[2];
    const float xx = x * x, yy = y * y, zz = z * z;
    dd[0] += kC2_0 * y * db[4];
    dd[1] += kC2_0 * x * db[4];
    dd[1] += kC2_1 * z * db[5];
    dd[2] += kC2_1 * y * db[5];
    dd[0] += kC2_2 * (-2.f * x) * db[6];
    dd[1] += kC2_2 * (-2.f * y) * db[6];
    dd[2] += kC2_2 * (4.f * z) * db[6];
    dd[0] += kC2_3 * z * db[7];
    dd[2] += kC2_3 * x * db[7];
    dd[0] += kC2_4 * (2.f * x) * db[8];
    dd[1] += kC2_4 * (-2.f * y) * db[8];
    if (ka > 9) {
      dd[0] += kC3_0 * (6.f * x * y) * db[9];
      dd[1] += kC3_0 * (3.f * xx - 3.f * yy) * db[9];
      dd[0] += kC3_1 * (y * z) * db[10];
      dd[1] += kC3_1 * (x * z) * db[10];
      dd[2] += kC3_1 * (x * y) * db[10];
      dd[0] += kC3_2 * (-2.f * x * y) * db[11];
      dd[1] += kC3_2 * (4.f * zz - xx - 3.f * yy) * db[11];
      dd[2] += kC3_2 * (8.f * y * z) * db[11];
      dd[0] += kC3_3 * (-6.f * x * z) * db[12];
      dd[1] += kC3_3 * (-6.f * y * z) * db[12];
      dd[2] += kC3_3 * (6.f * zz - 3.f * xx - 3.f * yy) * db[12];
      dd[0] += kC3_4 * (4.f * zz - 3.f * xx - yy) * db[13];
      dd[1] += kC3_4 * (-2.f * x * y) * db[13];
      dd[2] += kC3_4 * (8.f * x * z) * db[13];
      dd[0] += kC3_5 * (2.f * x * z) * db[14];
      dd[1] += kC3_5 * (-2.f * y * z) * db[14];
      dd[2] += kC3_5 * (xx - yy) * db[14];
      dd[0] += kC3_6 * (3.f * xx - 3.f * yy) * db[15];
      dd[1] += kC3_6 * (-6.f * x * y) * db[15];
    }
  }
  if (f.nz) {                        // d = v / |v|; else d is the constant 0
    const float dot = f.d[0] * dd[0] + f.d[1] * dd[1] + f.d[2] * dd[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) dxyz[k] += (dd[k] - f.d[k] * dot) / f.norm;
  }

  // --- column 5: opacity, times the antialiasing factor ---
  float dop = g[5], ddet_orig = 0.f, dsafe_det = 0.f;
  if (st.antialiasing) {
    dop = g[5] * f.h;
    const float dh = g[5] * f.op;
    if (f.ratio >= static_cast<float>(2.5e-5)) {
      const float dratio = dh / (2.f * f.h);
      ddet_orig = dratio / f.safe_det;
      dsafe_det = -dratio * ((f.det_orig / f.safe_det) / f.safe_det);
    }
  }
  d_opacity[i] = dop * (1.f - f.op) * f.op;

  // --- columns 2-4: conic = (c11, -c01, c00) / det, dilated ---
  const float dinv = g[2] * f.c11 - g[3] * f.c01 + g[4] * f.c00;
  dsafe_det += -dinv * (f.inv_det * f.inv_det);
  const float ddet = f.det != 0.f ? dsafe_det : 0.f;
  // c00 = c00o + dilation; det_orig = c00o c11o - c01^2
  const float A = g[4] * f.inv_det + ddet * f.c11 + ddet_orig * f.c11o;
  const float C = g[2] * f.inv_det + ddet * f.c00 + ddet_orig * f.c00o;
  const float B = -(g[3] * f.inv_det) - 2.f * (ddet + ddet_orig) * f.c01;

  // c00o = m0' S m0, c01 = m0' S m1, c11o = m1' S m1
  float dm0[3], dm1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dm0[k] = 2.f * A * f.s0[k] + B * f.s1[k];
    dm1[k] = B * f.s0[k] + 2.f * C * f.s1[k];
  }
  float dcov[6];
  {
    const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int a = I[e], b = J[e];
      float v = A * f.m0[a] * f.m0[b] + C * f.m1[a] * f.m1[b];
      if (a == b) {
        v += B * f.m0[a] * f.m1[a];
      } else {
        v = 2.f * v + B * (f.m0[a] * f.m1[b] + f.m0[b] * f.m1[a]);
      }
      dcov[e] = v;
    }
  }

  // m0 = a0 W0 + a2x W2, m1 = b1 W1 + b2y W2 (rows of world_view)
  const float* wv = cam.wv;
  const float da0 = dm0[0] * wv[0] + dm0[1] * wv[1] + dm0[2] * wv[2];
  const float da2x = dm0[0] * wv[8] + dm0[1] * wv[9] + dm0[2] * wv[10];
  const float db1 = dm1[0] * wv[4] + dm1[1] * wv[5] + dm1[2] * wv[6];
  const float db2y = dm1[0] * wv[8] + dm1[1] * wv[9] + dm1[2] * wv[10];
  const float it2 = f.inv_tz * f.inv_tz;
  // a0 = fx / tz', a2x = -fx tx / tz'^2 (tz' the guarded depth)
  const float dinv_tz = da0 * cam.fx + db1 * cam.fy +
                        2.f * f.inv_tz *
                            (da2x * (-cam.fx * f.tx) + db2y * (-cam.fy * f.ty));
  const float dtx = da2x * (-cam.fx) * it2;
  const float dty = db2y * (-cam.fy) * it2;
  float dsafe_tz = -dinv_tz * it2;
  const float tz = f.pv[2];
  // tx = clamp(pv0 / tz', +-1.3 tanfovx) * tz
  float dtz = dtx * f.txtz + dty * f.tytz;
  const float dqx = (f.qx >= -cam.limx && f.qx <= cam.limx) ? dtx * tz : 0.f;
  const float dqy = (f.qy >= -cam.limy && f.qy <= cam.limy) ? dty * tz : 0.f;
  const float dpv0 = dqx / f.safe_tz, dpv1 = dqy / f.safe_tz;
  dsafe_tz += -dqx * (f.qx / f.safe_tz) - dqy * (f.qy / f.safe_tz);
  if (!(fabsf(tz) < static_cast<float>(1e-6))) dtz += dsafe_tz;
  // --- column 9: invdepth = 1 / depth past the near plane ---
  if (tz > static_cast<float>(0.2)) dtz += -g[9] * (f.inv_depth * f.inv_depth);

  const float* fp = cam.fp;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    d_xyz[i3 + k] = dxyz[k] + dph0 * fp[k] + dph1 * fp[4 + k] +
                    dph3 * fp[12 + k] + dpv0 * wv[k] + dpv1 * wv[4 + k] +
                    dtz * wv[8 + k];

  // --- S = sum_k s2_k R_ik R_jk ---
  float ds2[3] = {0.f, 0.f, 0.f};
  float dR[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) dR[k] = 0.f;
  {
    const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float Rik = f.R[3 * I[e] + k], Rjk = f.R[3 * J[e] + k];
        ds2[k] += dcov[e] * Rik * Rjk;
        dR[3 * I[e] + k] += dcov[e] * f.s2[k] * Rjk;
        dR[3 * J[e] + k] += dcov[e] * f.s2[k] * Rik;
      }
    }
  }
  // s2 = (modifier s)^2, s = exp(log scale)
#pragma unroll
  for (int k = 0; k < 3; ++k)
    d_scaling[i3 + k] =
        ((ds2[k] * (2.f * f.ms[k])) * st.scaling_modifier) * f.s[k];

  // R of the unit quaternion u = (w, x, y, z)
  const float w = f.u[0], x = f.u[1], y = f.u[2], z = f.u[3];
  float du[4];
  du[0] = 2.f * (-z * dR[1] + y * dR[2] + z * dR[3] - x * dR[5] - y * dR[6] +
                 x * dR[7]);
  du[1] = 2.f * (y * dR[1] + z * dR[2] + y * dR[3] - w * dR[5] + z * dR[6] +
                 w * dR[7]) -
          4.f * x * (dR[4] + dR[8]);
  du[2] = 2.f * (x * dR[1] + w * dR[2] + x * dR[3] + z * dR[5] - w * dR[6] +
                 z * dR[7]) -
          4.f * y * (dR[0] + dR[8]);
  du[3] = 2.f * (-w * dR[1] + x * dR[2] + w * dR[3] + y * dR[5] + x * dR[6] +
                 y * dR[7]) -
          4.f * z * (dR[0] + dR[4]);
  // u = r / |r| (quat_to_rotmat), r = q / |q| (get_rotation)
  float dr[4], dq[4];
  normalize_bwd4(f.u, f.rn, du, dr);
  normalize_bwd4(f.r, f.qn, dr, dq);
#pragma unroll
  for (int k = 0; k < 4; ++k) d_rotation[4LL * i + k] = dq[k];
}

__global__ void __launch_bounds__(kThreads)
preprocess_bwd_kernel(Setup st, const float* __restrict__ xyz,
                      const float* __restrict__ scaling,
                      const float* __restrict__ rotation,
                      const float* __restrict__ opacity,
                      const float* __restrict__ f_dc,
                      const float* __restrict__ f_rest,
                      const unsigned char* __restrict__ active,
                      const float* __restrict__ d_packed,
                      float* __restrict__ d_xyz, float* __restrict__ d_scaling,
                      float* __restrict__ d_rotation,
                      float* __restrict__ d_opacity,
                      float* __restrict__ d_f_dc, float* __restrict__ d_f_rest,
                      float* __restrict__ d_tap) {
  extern __shared__ float d_rest[];        // (kThreads, K-1, 3)
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
  const int per_row = 3 * (st.n_coeffs - 1);
  const long long base = static_cast<long long>(i0) * per_row;
  if (i < st.n)
    backward(st, i, xyz, scaling, rotation, opacity, f_dc,
             f_rest + base + threadIdx.x * per_row,
             d_rest + threadIdx.x * per_row, active, d_packed, d_xyz,
             d_scaling, d_rotation, d_opacity, d_f_dc, d_tap);
  __syncthreads();
  copy_block(d_rest, d_f_rest + base, min(kThreads, st.n - i0) * per_row);
}

}  // namespace

extern "C" {

// The inputs of gsplat_preprocess_fwd (the tap's value is not needed) and
// d_packed (N+1, 16) float32, contiguous. Out, float32 and contiguous:
// d_xyz, d_scaling (N, 3), d_rotation (N, 4), d_opacity (N,), d_f_dc
// (N, 3), d_f_rest (N, K-1, 3), and d_tap (N, 2) or null. Launches on
// `stream`; returns the launch's cudaError_t (0 on success).
int gsplat_preprocess_bwd(
    const float* xyz, const float* scaling, const float* rotation,
    const float* opacity, const float* f_dc, const float* f_rest,
    const unsigned char* active, const float* world_view,
    const float* full_proj, const float* cam_center, const float* tanfovx,
    const float* tanfovy, int n, int n_coeffs, int active_sh_degree,
    int width, int height, float scaling_modifier, int antialiasing,
    float dilation, float alpha_min, const float* d_packed, float* d_xyz,
    float* d_scaling, float* d_rotation, float* d_opacity, float* d_f_dc,
    float* d_f_rest, float* d_tap, void* stream) {
  if (n < 0 || n_coeffs < 1 || n_coeffs > kMaxCoeffs)
    return cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Setup st = make_setup(world_view, full_proj, cam_center, tanfovx,
                              tanfovy, n, n_coeffs, active_sh_degree, width,
                              height, scaling_modifier, antialiasing,
                              dilation, alpha_min);
  const int blocks = (n + kThreads - 1) / kThreads;
  const int smem = kThreads * 3 * (n_coeffs - 1) * sizeof(float);
  preprocess_bwd_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      st, xyz, scaling, rotation, opacity, f_dc, f_rest, active, d_packed,
      d_xyz, d_scaling, d_rotation, d_opacity, d_f_dc, d_f_rest, d_tap);
  return cudaGetLastError();
}

}  // extern "C"
