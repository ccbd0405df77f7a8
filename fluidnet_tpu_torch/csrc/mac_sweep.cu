// K1: the fused MacCormack advection sweep, in its two forms.
//
// Replaces the TPU kernel fluidnet_tpu/ops/pallas/mac_sweep.py::_sweep_kernel
// as launched by
//   - advect_sweep_fused_ep (fuse_ep=True, with_scalar=True), the inference
//     path: one forward sweep (dcoef = -dt) and one backward sweep
//     (dcoef = +dt) per simulation step (FUSE = true);
//   - advect_sweep / mac_vel_sweep (fuse_ep=False), the unfused forms that
//     training differentiates: the raw warps, bounds and renormalisation
//     channels, with or without the scalar (FUSE = false).
// Per cell, the kernel
//   1. derives the backtrace positions of the three MAC components
//      (getAtMAC, zero-filled at the domain edge) and of the cell-centered
//      scalar (getCentered, zero on the 1-cell border): d = dcoef * vel,
//      scaled into the Chebyshev free space for the 'Ours' methods, clipped
//      to +-(W - 1e-3), p = cell_index + d;
//   2. warps u (forward) or fwd_u (backward), and the scalar with its
//      mask-renormalized num/den, trilinearly with BUILD_INDEX border
//      clamps; tracks min/max over the 2x2x2 corner support (of u on both
//      sweeps, of the fluid-masked scalar on the forward sweep);
//   3. FUSE: applies the epilogue: fluid/border masks and the renorm
//      combine (forward), the MacCormack correction with its per-component
//      fluid skips (backward). Otherwise writes the raw channels
//      (mac_sweep.py:545-558): u_w(3), u_mn(3), u_mx(3), then with the
//      scalar s_plain [, s_num, s_den] and on the forward sweep s_mn, s_mx:
//      9 to 14 channels.
//
// What bounds it on the H100: memory traffic. Each cell reads ~18 velocity
// neighbours for its positions and 8 corners per warped field (3 MAC
// components + scalar, num/den from the same corners), and writes 9 to 14
// floats: 48 B/cell of compulsory HBM traffic for the fused forward sweep,
// 80 B/cell for the unfused forward sweep with scalar and renorm (inputs
// once, outputs once), against ~150 gathered reads per cell that must hit
// L1/L2. At 128^3 every input field is 8 MB, so the whole working set (u, s,
// m, free, fwd_u, fwd_s: 40 MB) fits the 50 MB L2.
//
// Design: the TPU's (2W+1)^3 roll-based tap window, z-blocking and lane
// padding are gone. One thread per output cell (x fastest, so a warp reads
// contiguous rows), corners gathered straight from global memory through
// the read-only path and left to L1/L2, no shared memory. The window W only
// enters as the displacement clip. Arithmetic follows the JAX kernel
// operation for operation (built with -fmad=false), so the kernel agrees
// with its plain PyTorch version (ops/cuda/mac_sweep.py) to the last bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kEps = 1e-3f;

struct Grid {
  int Z, Y, X;
  __device__ __forceinline__ int at(int k, int j, int i) const {
    return (k * Y + j) * X + i;
  }
  __device__ __forceinline__ bool in(int k, int j, int i) const {
    return k >= 0 && k < Z && j >= 0 && j < Y && i >= 0 && i < X;
  }
};

// A field read with the zero fill of ops.stencil.shift outside the domain.
__device__ __forceinline__ float ld0(const float* __restrict__ f,
                                     const Grid& g, int k, int j, int i) {
  return g.in(k, j, i) ? __ldg(f + g.at(k, j, i)) : 0.f;
}

struct Axis {
  int i;
  float w0, w1;
};

// BUILD_INDEX (warp.py:_corner_weights, mac_sweep.py:142-152): p is an
// index-offset position. p < 0 -> corner 0 with weight 1; a base corner at
// or past n-1 -> corners {n-2, n-1} with weights {0, 1}.
__device__ __forceinline__ Axis build_index(float p, int n) {
  float fi = floorf(p);
  Axis a{static_cast<int>(fi), 0.f, p - fi};
  a.w0 = 1.f - a.w1;
  if (p < 0.f) {
    a.i = 0;
    a.w0 = 1.f;
    a.w1 = 0.f;
  }
  if (a.i >= n - 1) {
    a.i = n - 2;
    a.w0 = 0.f;
    a.w1 = 1.f;
  }
  return a;
}

struct Pos {
  float x, y, z;
};

template <bool OURS>
__device__ __forceinline__ Pos backtrace(float vx, float vy, float vz,
                                         float dcoef, float allowed,
                                         float lim, int k, int j, int i) {
  float dx = dcoef * vx, dy = dcoef * vy, dz = dcoef * vz;
  if (OURS) {
    float mag = fmaxf(fmaxf(fabsf(dx), fabsf(dy)), fabsf(dz));
    float scale = fminf(1.f, allowed / fmaxf(mag, 1e-12f));
    dx = dx * scale;
    dy = dy * scale;
    dz = dz * scale;
  }
  return Pos{static_cast<float>(i) + fminf(fmaxf(dx, -lim), lim),
             static_cast<float>(j) + fminf(fmaxf(dy, -lim), lim),
             static_cast<float>(k) + fminf(fmaxf(dz, -lim), lim)};
}

struct Corners {
  int idx[8];
  float w[8];
};

// The 8 support corners in the order the JAX kernel accumulates its taps
// (z slice, then y row, then x lane, each ascending); weight = (wz*wy)*wx.
__device__ __forceinline__ Corners corners(const Pos& p, const Grid& g) {
  Axis ax = build_index(p.x, g.X), ay = build_index(p.y, g.Y),
       az = build_index(p.z, g.Z);
  Corners c;
  int n = 0;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    float wz = dz ? az.w1 : az.w0;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      float wzy = wz * (dy ? ay.w1 : ay.w0);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        c.idx[n] = g.at(az.i + dz, ay.i + dy, ax.i + dx);
        c.w[n] = wzy * (dx ? ax.w1 : ax.w0);
        ++n;
      }
    }
  }
  return c;
}

// SCALAR: the scalar group is warped too (always with FUSE). s is read by
// the forward sweep and by the fused backward sweep, m whenever SCALAR.
template <bool IS_BWD, bool OURS, bool RENORM, bool SCALAR, bool FUSE>
__global__ void __launch_bounds__(256)
mac_sweep_kernel(const float* __restrict__ u, const float* __restrict__ s,
                 const float* __restrict__ m,
                 const float* __restrict__ fwd_u,
                 const float* __restrict__ fwd_s,
                 const float* __restrict__ free_space,
                 float* __restrict__ out, int B, Grid g, float dcoef,
                 float strength, float lim) {
  static_assert(SCALAR || !FUSE, "the fused epilogue warps the scalar");
  const int n = g.Z * g.Y * g.X;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= B * n) return;
  const int b = gid / n;
  const int c0 = gid - b * n;
  const int i = c0 % g.X;
  const int j = (c0 / g.X) % g.Y;
  const int k = c0 / (g.X * g.Y);

  const float* U0 = u + (size_t)b * 3 * n;
  const float* U1 = U0 + n;
  const float* U2 = U1 + n;
  const float* S = s + (size_t)b * n;
  const float* M = m + (size_t)b * n;
  // Warped velocity: u forward, fwd_u backward; bounds always from u.
  const float* WU = IS_BWD ? fwd_u + (size_t)b * 3 * n : U0;
  // Warped scalar: s forward, fwd_s backward.
  const float* WS = IS_BWD ? fwd_s + (size_t)b * n : S;
  const float* Us[3] = {U0, U1, U2};

  // Face / center velocities (getAtMACX/Y/Z, getCentered).
  const float u0 = __ldg(U0 + c0), u1 = __ldg(U1 + c0), u2 = __ldg(U2 + c0);
  float vel[4][3];
  vel[0][0] = u0;
  vel[0][1] = 0.25f * (u1 + ld0(U1, g, k, j, i - 1) + ld0(U1, g, k, j + 1, i) +
                       ld0(U1, g, k, j + 1, i - 1));
  vel[0][2] = 0.25f * (u2 + ld0(U2, g, k, j, i - 1) + ld0(U2, g, k + 1, j, i) +
                       ld0(U2, g, k + 1, j, i - 1));
  vel[1][0] = 0.25f * (u0 + ld0(U0, g, k, j - 1, i) + ld0(U0, g, k, j, i + 1) +
                       ld0(U0, g, k, j - 1, i + 1));
  vel[1][1] = u1;
  vel[1][2] = 0.25f * (u2 + ld0(U2, g, k, j - 1, i) + ld0(U2, g, k + 1, j, i) +
                       ld0(U2, g, k + 1, j - 1, i));
  vel[2][0] = 0.25f * (u0 + ld0(U0, g, k - 1, j, i) + ld0(U0, g, k, j, i + 1) +
                       ld0(U0, g, k - 1, j, i + 1));
  vel[2][1] = 0.25f * (u1 + ld0(U1, g, k - 1, j, i) + ld0(U1, g, k, j + 1, i) +
                       ld0(U1, g, k - 1, j + 1, i));
  vel[2][2] = u2;
  const bool border = i == 0 || i == g.X - 1 || j == 0 || j == g.Y - 1 ||
                      k == 0 || k == g.Z - 1;
  vel[3][0] = border ? 0.f : 0.5f * (u0 + ld0(U0, g, k, j, i + 1));
  vel[3][1] = border ? 0.f : 0.5f * (u1 + ld0(U1, g, k, j + 1, i));
  vel[3][2] = border ? 0.f : 0.5f * (u2 + ld0(U2, g, k + 1, j, i));

  const float allowed =
      OURS ? fmaxf(__ldg(free_space + (size_t)b * n + c0) - 0.5f - kEps, 0.f)
           : 0.f;
  const bool fl = SCALAR ? __ldg(M + c0) > 0.5f : true;

  float acc[3], mn[3], mx[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    Pos p = backtrace<OURS>(vel[c][0], vel[c][1], vel[c][2], dcoef, allowed,
                            lim, k, j, i);
    Corners cr = corners(p, g);
    const float* src = WU + (size_t)c * n;
    float a = 0.f, lo = INFINITY, hi = -INFINITY;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float v = __ldg(src + cr.idx[t]);
      a = a + v * cr.w[t];
      float bv = IS_BWD ? __ldg(Us[c] + cr.idx[t]) : v;
      lo = fminf(lo, bv);
      hi = fmaxf(hi, bv);
    }
    acc[c] = a;
    mn[c] = lo;
    mx[c] = hi;
  }

  if constexpr (!SCALAR) {
    // mac_vel_sweep: u_w(3), u_mn(3), u_mx(3).
    const size_t ob = (size_t)b * 9 * n + c0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[ob + (size_t)c * n] = acc[c];
      out[ob + (size_t)(3 + c) * n] = mn[c];
      out[ob + (size_t)(6 + c) * n] = mx[c];
    }
    return;
  }

  // Scalar group. Forward 'Ours': non-fluid cells warp their own centers.
  Pos ps = backtrace<OURS>(vel[3][0], vel[3][1], vel[3][2], dcoef, allowed,
                           lim, k, j, i);
  if (!IS_BWD && OURS && !fl) {
    ps = Pos{static_cast<float>(i), static_cast<float>(j),
             static_cast<float>(k)};
  }
  Corners cs = corners(ps, g);
  float plain = 0.f, num = 0.f, den = 0.f, smn = INFINITY, smx = -INFINITY;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    float sv = __ldg(WS + cs.idx[t]);
    plain = plain + sv * cs.w[t];
    if (RENORM) {
      float mv = __ldg(M + cs.idx[t]);
      num = num + (sv * mv) * cs.w[t];
      den = den + mv * cs.w[t];
      if (!IS_BWD) {
        smn = fminf(smn, mv > 0.5f ? sv : kBig);
        smx = fmaxf(smx, mv > 0.5f ? sv : -kBig);
      }
    } else if (!IS_BWD) {
      smn = fminf(smn, sv);
      smx = fmaxf(smx, sv);
    }
  }
  if constexpr (!FUSE) {
    // advect_sweep: u_w, u_mn, u_mx, s_plain [, s_num, s_den] [, s_mn,
    // s_mx on the forward sweep].
    constexpr int nx = 9 + (RENORM ? 3 : 1);
    const size_t ob = (size_t)b * (nx + (IS_BWD ? 0 : 2)) * n + c0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[ob + (size_t)c * n] = acc[c];
      out[ob + (size_t)(3 + c) * n] = mn[c];
      out[ob + (size_t)(6 + c) * n] = mx[c];
    }
    out[ob + (size_t)9 * n] = plain;
    if (RENORM) {
      out[ob + (size_t)10 * n] = num;
      out[ob + (size_t)11 * n] = den;
    }
    if (!IS_BWD) {
      out[ob + (size_t)nx * n] = smn;
      out[ob + (size_t)(nx + 1) * n] = smx;
    }
    return;
  }

  float val = plain;
  if (RENORM && den > 1e-6f) val = num / den;

  const size_t ob = (size_t)b * (IS_BWD ? 10 : 12) * n + c0;
  if (!IS_BWD) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = (OURS && !fl) ? __ldg(Us[c] + c0) : acc[c];
      out[ob + (size_t)c * n] = border ? 0.f : v;
      out[ob + (size_t)(3 + c) * n] = mn[c];
      out[ob + (size_t)(6 + c) * n] = mx[c];
    }
    if (OURS && !fl) val = __ldg(S + c0);
    out[ob + (size_t)9 * n] = border ? 0.f : val;
    out[ob + (size_t)10 * n] = smn;
    out[ob + (size_t)11 * n] = smx;
    return;
  }

  // Backward: MacCormack correction (MacCormackCorrectMAC,
  // tfluids.cc:660-699). Component c is skipped where the cell or its -c
  // neighbour is non-fluid; the neighbour counts as fluid at the low edge.
  const bool skip_ok[3] = {i == 0 || __ldg(M + c0 - 1) > 0.5f,
                           j == 0 || __ldg(M + c0 - g.X) > 0.5f,
                           k == 0 || __ldg(M + c0 - g.X * g.Y) > 0.5f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float fwd_c = __ldg(WU + (size_t)c * n + c0);
    float bwd_c = (OURS && !fl) ? fwd_c : acc[c];
    if (border) bwd_c = 0.f;
    const float uc = __ldg(Us[c] + c0);
    const float corr = fwd_c + strength * 0.5f * (uc - bwd_c);
    out[ob + (size_t)c * n] = (fl && skip_ok[c]) ? corr : fwd_c;
    out[ob + (size_t)(3 + c) * n] = mn[c];
    out[ob + (size_t)(6 + c) * n] = mx[c];
  }
  const float fwd_sc = __ldg(WS + c0);
  if (OURS && !fl) val = fwd_sc;
  const float bwd_s = border ? 0.f : val;
  out[ob + (size_t)9 * n] =
      fwd_sc + (fl ? strength * 0.5f * (__ldg(S + c0) - bwd_s) : 0.f);
}

struct Args {
  const float *u, *s, *m, *fwd_u, *fwd_s, *fr;
  float* out;
  int B;
  Grid g;
  float dcoef, strength, lim;
};

template <bool IS_BWD, bool OURS, bool RENORM, bool SCALAR, bool FUSE>
void launch(const Args& a, cudaStream_t st) {
  const int total = a.B * a.g.Z * a.g.Y * a.g.X;
  mac_sweep_kernel<IS_BWD, OURS, RENORM, SCALAR, FUSE>
      <<<(total + 255) / 256, 256, 0, st>>>(a.u, a.s, a.m, a.fwd_u, a.fwd_s,
                                            a.fr, a.out, a.B, a.g, a.dcoef,
                                            a.strength, a.lim);
}

// The form: FUSE (fused epilogue, scalar), SCALAR (unfused with the
// scalar) or neither (velocity only; renorm ignored).
template <bool IS_BWD, bool OURS>
void launch_form(bool renorm, bool scalar, bool fuse, const Args& a,
                 cudaStream_t st) {
  if (fuse) {
    if (renorm)
      launch<IS_BWD, OURS, true, true, true>(a, st);
    else
      launch<IS_BWD, OURS, false, true, true>(a, st);
  } else if (scalar) {
    if (renorm)
      launch<IS_BWD, OURS, true, true, false>(a, st);
    else
      launch<IS_BWD, OURS, false, true, false>(a, st);
  } else {
    launch<IS_BWD, OURS, false, false, false>(a, st);
  }
}

}  // namespace

// fuse != 0: out (B, 12, Z, Y, X) forward [u_w(3), u_mn(3), u_mx(3), s_val,
// s_mn, s_mx], (B, 10, Z, Y, X) backward [u_w(3) = corrected u, u_mn(3),
// u_mx(3), s_val = corrected s]; s and m always read, fwd_s backward.
// fuse == 0: the raw channels of mac_sweep.py:545-558, (B, 9, ...) without
// the scalar (s, m, fwd_s unread, may be null), else (B, 9 + (renorm ? 3 :
// 1) + (is_bwd ? 0 : 2), ...); s is read forward only. fwd_u/fwd_s are
// null on the forward sweep, free_space is null unless `ours`. Returns
// cudaGetLastError().
extern "C" int fluidnet_mac_sweep(const float* u, const float* s,
                                  const float* m, const float* fwd_u,
                                  const float* fwd_s, const float* free_space,
                                  float* out, int B, int Z, int Y, int X,
                                  float dcoef, float strength, float lim,
                                  int is_bwd, int ours, int renorm,
                                  int scalar, int fuse, void* stream) {
  if (fuse && !scalar) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{u, s, m, fwd_u, fwd_s, free_space, out, B, Grid{Z, Y, X},
               dcoef, strength, lim};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bwd) {
    if (ours)
      launch_form<true, true>(renorm, scalar, fuse, a, st);
    else
      launch_form<true, false>(renorm, scalar, fuse, a, st);
  } else {
    if (ours)
      launch_form<false, true>(renorm, scalar, fuse, a, st);
    else
      launch_form<false, false>(renorm, scalar, fuse, a, st);
  }
  return static_cast<int>(cudaGetLastError());
}
