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
//      to +-(W - 1e-3), p = cell_index + d. The z index is global: the
//      array's first plane is z0 (a slab of a z-sharded grid; 0 for a
//      whole grid), so a weight p - floor(p) rounds as the whole grid's,
//      and a corner's plane in the array is floor(p) - z0;
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
// What bounds it on the H100: compulsory HBM traffic is 72 B/cell for the
// fused forward sweep (u, s, m, free in: 24 B; 12 channels out: 48 B), 80
// B/cell for the fused backward sweep and 80 / 84 B/cell for the unfused
// forward / backward sweep with scalar and renorm; at 128^3 the bytes take
// 0.045-0.053 ms. Against that, a cell reads ~18 velocity neighbours for
// its positions and 8 corners per warped field (3 MAC components + scalar,
// num/den from the same corners; the backward sweep's bounds 24 more): ~90
// reads and, compiled, ~900-1000 instructions a cell, ~60% of them
// addressing, selects and predicates (scripts/torch_sass_census.py). So
// instruction issue bounds it once the reads are local, and latency
// before: one thread per cell gathering from global memory made two
// dependent rounds of loads a cell with nothing to hide them, and ran as
// fast at rest (each corner load of a warp one row) as on a random flow.
// The window keeps every read local: the clip at +-(W - 1e-3) and
// BUILD_INDEX's in-domain clamps put each corner in [i - W, i + W] on each
// axis, the velocity neighbours in [i - 1, i + 1].
//
// Design: one template for the per-cell arithmetic (sweep_cell), read
// through one of two sources, so both routes compute the same float32
// operations in the same order as the plain version (built with
// -fmad=false: equal to the bit).
//   - Tiled (W = 1, 2): a z-march over shared-memory tiles. A block owns a
//     32 x TY output tile (TY = 8 or 16) and a range of planes
//     (ops/cuda/mac_sweep.py's sweep_tiling picks them to fill one wave of
//     the resident blocks), one thread a column of the tile. Each input
//     plane of the tile grown by W on each side is read from HBM once: at
//     the step for output plane k the block asks cp.async for plane
//     k + W + kAhead into a ring of 2W + 1 + kAhead planes (src-size 0
//     zero-fills outside the domain, which is the plain version's fill),
//     waits for plane k + W, meets its one barrier, and computes plane k
//     from planes k - W .. k + W. One plane in flight is enough: a step
//     of the resident blocks takes microseconds, a plane's load less.
//     Every velocity neighbour, warp corner, bound corner and the backward
//     skip test's m reads come from shared memory, addressed in tile
//     coordinates from the ring's plane offsets, which the step computes
//     once; only free space (and the backward sweep's s) are read at the
//     centre from global memory. To cut issue: BUILD_INDEX as clamps
//     without branches, the 'Ours' division only where the scale is below
//     1, sums and bounds started from the first corner. Shared memory and
//     ~60 registers leave 32 warps an SM.
//   - Global (W >= 3: the configurations set windows 1 and 2, and each
//     window the tiled route instantiates is 20 kernels more to build;
//     and a global index above 2^15 (z0 + Z in z), where the float32
//     i + (W - 1e-3) rounds to i + W and a corner falls outside the
//     tile): one thread per
//     output cell, every read a gather through the read-only path left to
//     L1/L2.

#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"

namespace {

constexpr float kBig = 1e30f;
constexpr float kEps = 1e-3f;
constexpr int kTX = 32;      // output tile width (x)
constexpr int kAhead = 1;    // input planes in flight beyond those read

// Channels of a sweep's sources: u (3), fwd_u (3, backward), the warped
// scalar (s forward, fwd_s backward) and the mask m.
enum Chan { kU = 0, kFU = 3, kWS = 6, kM = 7 };

struct Grid {
  int Z, Y, X;
  int z0;   // global index of plane 0
  __device__ __forceinline__ int at(int k, int j, int i) const {
    return (k * Y + j) * X + i;
  }
  __device__ __forceinline__ bool in(int k, int j, int i) const {
    return k >= 0 && k < Z && j >= 0 && j < Y && i >= 0 && i < X;
  }
};

struct Axis {
  int i;
  float w0, w1;
};

// BUILD_INDEX (warp.py:_corner_weights, mac_sweep.py:142-152): p is an
// index-offset position along an axis of n cells whose first is global
// index lo. p < lo -> corner lo with weight 1; a base corner at or past
// lo + n - 1 -> corners {lo + n - 2, lo + n - 1} with weights {0, 1}.
// Without branches: p clamped to [lo, lo + n - 1] and its floor to
// lo + n - 2 give the same corner and the same weights to the bit (w1 =
// lo - lo and (lo + n - 1) - (lo + n - 2) are exact, and inside the range
// nothing moves). Returns the corner's index into the array (less lo).
__device__ __forceinline__ Axis build_index(float p, int lo, int n) {
  const float pc = fminf(fmaxf(p, static_cast<float>(lo)),
                         static_cast<float>(lo + n - 1));
  const float fi = fminf(floorf(pc), static_cast<float>(lo + n - 2));
  Axis a{static_cast<int>(fi) - lo, 0.f, pc - fi};
  a.w0 = 1.f - a.w1;
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
    const float mag = fmaxf(fmaxf(fabsf(dx), fabsf(dy)), fabsf(dz));
    const float m = fmaxf(mag, 1e-12f);
    // allowed >= m rounds allowed / m to >= 1: the scale is 1 exactly, so
    // the division (and its slow-path check) is only taken below.
    float scale = 1.f;
    if (allowed < m) scale = fminf(1.f, allowed / m);
    dx = dx * scale;
    dy = dy * scale;
    dz = dz * scale;
  }
  return Pos{static_cast<float>(i) + fminf(fmaxf(dx, -lim), lim),
             static_cast<float>(j) + fminf(fmaxf(dy, -lim), lim),
             static_cast<float>(k) + fminf(fmaxf(dz, -lim), lim)};
}

// The 8 corner weights in the order the JAX kernel accumulates its taps
// (z slice, then y row, then x lane, each ascending): (wz * wy) * wx.
__device__ __forceinline__ void weights(const Axis& ax, const Axis& ay,
                                        const Axis& az, float w[8]) {
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float wz = dz ? az.w1 : az.w0;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wzy = wz * (dy ? ay.w1 : ay.w0);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
        w[dz * 4 + dy * 2 + dx] = wzy * (dx ? ax.w1 : ax.w0);
    }
  }
}

// The global route's source: every read a gather from global memory, zero
// outside the domain (ops.stencil.shift's fill).
struct GlobalSrc {
  const float* ch[8];      // kU.., kFU.., kWS, kM, batch item b
  const float* S;          // s (read at the centre by the backward sweep)
  const float* fr;         // free space
  Grid g;
  int k, j, i, c0;
  struct Taps {
    int idx[8];
    float w[8];
  };
  __device__ __forceinline__ float nb(int c, int dz, int dy, int dx) const {
    return g.in(k + dz, j + dy, i + dx)
               ? __ldg(ch[c] + g.at(k + dz, j + dy, i + dx))
               : 0.f;
  }
  __device__ __forceinline__ float at(int c) const {
    return __ldg(ch[c] + c0);
  }
  __device__ __forceinline__ float s_at() const { return __ldg(S + c0); }
  __device__ __forceinline__ float free_at() const { return __ldg(fr + c0); }
  __device__ __forceinline__ Taps taps(const Pos& p) const {
    const Axis ax = build_index(p.x, 0, g.X), ay = build_index(p.y, 0, g.Y),
               az = build_index(p.z, g.z0, g.Z);
    Taps t;
    weights(ax, ay, az, t.w);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      t.idx[n] = g.at(az.i + (n >> 2), ay.i + ((n >> 1) & 1), ax.i + (n & 1));
    return t;
  }
  __device__ __forceinline__ float tap(int c, const Taps& t, int n) const {
    return __ldg(ch[c] + t.idx[n]);
  }
};

// The tiled route's shared memory: a ring of R input planes, each NC
// channels of the SX x SY tile grown by W (the staged channels of the
// form, in Chan order); slot q holds plane zs - W + r with r % R == q.
template <int W, int TY, bool IS_BWD, bool SCALAR>
struct Ring {
  static constexpr int SX = kTX + 2 * W, SY = TY + 2 * W, P = SX * SY;
  static constexpr int R = 2 * W + 1 + kAhead;
  static constexpr int NC = 3 + (IS_BWD ? 3 : 0) + (SCALAR ? 2 : 0);
  static constexpr int kThreads = kTX * TY;
  static constexpr int PER = (P + kThreads - 1) / kThreads;  // cells a thread
  static constexpr int kBytes = 4 * R * NC * P;
  // The shared-memory channel of a Chan.
  __host__ __device__ static constexpr int chan(int c) {
    return c < kFU ? c : c < kWS ? c : (c - kWS) + (IS_BWD ? 6 : 3);
  }
};

// The tiled route's source: reads from the ring in tile coordinates.
template <int W, int TY, bool IS_BWD, bool SCALAR>
struct TileSrc {
  using T = Ring<W, TY, IS_BWD, SCALAR>;
  const float* sm;   // the ring
  int base[2 * W + 1];   // offset of planes k - W .. k + W in the ring
  int kw, oy, ox;    // array indices of the tile's first plane, row, column
  int cc;            // the thread's cell in a plane
  const float* S;    // s at the cell (backward sweep), global
  const float* fr;   // free space at the cell, global
  int Z, Y, X, z0;
  struct Taps {
    int b0, b1;      // the corners' lower-z and upper-z (0, 0, 0) addresses
    float w[8];
  };
  // base[e] for a runtime e in [0, 2W].
  __device__ __forceinline__ int pick(int e) const {
    int b = base[0];
#pragma unroll
    for (int q = 1; q <= 2 * W; ++q) b = e == q ? base[q] : b;
    return b;
  }
  __device__ __forceinline__ float nb(int c, int dz, int dy, int dx) const {
    return sm[base[W + dz] + T::chan(c) * T::P + cc + dy * T::SX + dx];
  }
  __device__ __forceinline__ float at(int c) const { return nb(c, 0, 0, 0); }
  __device__ __forceinline__ float s_at() const { return __ldg(S); }
  __device__ __forceinline__ float free_at() const { return __ldg(fr); }
  __device__ __forceinline__ Taps taps(const Pos& p) const {
    const Axis ax = build_index(p.x, 0, X), ay = build_index(p.y, 0, Y),
               az = build_index(p.z, z0, Z);
    Taps t;
    weights(ax, ay, az, t.w);
    const int e = az.i - kw;   // in [0, 2W - 1]: the window's guarantee
    const int row = (ay.i - oy) * T::SX + (ax.i - ox);
    t.b0 = pick(e) + row;
    t.b1 = pick(e + 1) + row;
    return t;
  }
  __device__ __forceinline__ float tap(int c, const Taps& t, int n) const {
    return sm[(n < 4 ? t.b0 : t.b1) + T::chan(c) * T::P +
              ((n >> 1) & 1) * T::SX + (n & 1)];
  }
};

// One output cell (k, j, i) of batch item b: out points at the cell in
// channel 0 of the item's output, n = Z * Y * X. SCALAR: the scalar group
// is warped too (always with FUSE).
template <bool IS_BWD, bool OURS, bool RENORM, bool SCALAR, bool FUSE,
          class Src>
__device__ __forceinline__ void sweep_cell(const Src& src, float* out,
                                           int n, const Grid& g, int k,
                                           int j, int i, float dcoef,
                                           float strength, float lim) {
  static_assert(SCALAR || !FUSE, "the fused epilogue warps the scalar");
  // Face / center velocities (getAtMACX/Y/Z, getCentered).
  const float u0 = src.at(kU), u1 = src.at(kU + 1), u2 = src.at(kU + 2);
  float vel[4][3];
  vel[0][0] = u0;
  vel[0][1] = 0.25f * (u1 + src.nb(1, 0, 0, -1) + src.nb(1, 0, 1, 0) +
                       src.nb(1, 0, 1, -1));
  vel[0][2] = 0.25f * (u2 + src.nb(2, 0, 0, -1) + src.nb(2, 1, 0, 0) +
                       src.nb(2, 1, 0, -1));
  vel[1][0] = 0.25f * (u0 + src.nb(0, 0, -1, 0) + src.nb(0, 0, 0, 1) +
                       src.nb(0, 0, -1, 1));
  vel[1][1] = u1;
  vel[1][2] = 0.25f * (u2 + src.nb(2, 0, -1, 0) + src.nb(2, 1, 0, 0) +
                       src.nb(2, 1, -1, 0));
  vel[2][0] = 0.25f * (u0 + src.nb(0, -1, 0, 0) + src.nb(0, 0, 0, 1) +
                       src.nb(0, -1, 0, 1));
  vel[2][1] = 0.25f * (u1 + src.nb(1, -1, 0, 0) + src.nb(1, 0, 1, 0) +
                       src.nb(1, -1, 1, 0));
  vel[2][2] = u2;
  const bool border = i == 0 || i == g.X - 1 || j == 0 || j == g.Y - 1 ||
                      k == 0 || k == g.Z - 1;
  vel[3][0] = border ? 0.f : 0.5f * (u0 + src.nb(0, 0, 0, 1));
  vel[3][1] = border ? 0.f : 0.5f * (u1 + src.nb(1, 0, 1, 0));
  vel[3][2] = border ? 0.f : 0.5f * (u2 + src.nb(2, 1, 0, 0));

  const float allowed =
      OURS ? fmaxf(src.free_at() - 0.5f - kEps, 0.f) : 0.f;
  const int kg = k + g.z0;   // the plane's global index
  const bool fl = SCALAR ? src.at(kM) > 0.5f : true;

  // Warped velocity: u forward, fwd_u backward; bounds always from u.
  constexpr int kWU = IS_BWD ? kFU : kU;
  float acc[3], mn[3], mx[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Pos p = backtrace<OURS>(vel[c][0], vel[c][1], vel[c][2], dcoef,
                                  allowed, lim, kg, j, i);
    const auto cr = src.taps(p);
    // Each sum and bound starts from the first corner, as the plain
    // version's.
    float a = 0.f, lo = 0.f, hi = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float v = src.tap(kWU + c, cr, t);
      a = t ? a + v * cr.w[t] : v * cr.w[t];
      const float bv = IS_BWD ? src.tap(kU + c, cr, t) : v;
      lo = t ? fminf(lo, bv) : bv;
      hi = t ? fmaxf(hi, bv) : bv;
    }
    acc[c] = a;
    mn[c] = lo;
    mx[c] = hi;
  }

  if constexpr (!SCALAR) {
    // mac_vel_sweep: u_w(3), u_mn(3), u_mx(3).
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c * n] = acc[c];
      out[(3 + c) * n] = mn[c];
      out[(6 + c) * n] = mx[c];
    }
    return;
  }

  // Scalar group. Forward 'Ours': non-fluid cells warp their own centers.
  Pos ps = backtrace<OURS>(vel[3][0], vel[3][1], vel[3][2], dcoef, allowed,
                           lim, kg, j, i);
  if (!IS_BWD && OURS && !fl) {
    ps = Pos{static_cast<float>(i), static_cast<float>(j),
             static_cast<float>(kg)};
  }
  const auto cs = src.taps(ps);
  float plain = 0.f, num = 0.f, den = 0.f, smn = 0.f, smx = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float sv = src.tap(kWS, cs, t);
    plain = t ? plain + sv * cs.w[t] : sv * cs.w[t];
    float lo = sv, hi = sv;
    if (RENORM) {
      const float mv = src.tap(kM, cs, t);
      num = t ? num + (sv * mv) * cs.w[t] : (sv * mv) * cs.w[t];
      den = t ? den + mv * cs.w[t] : mv * cs.w[t];
      lo = mv > 0.5f ? sv : kBig;
      hi = mv > 0.5f ? sv : -kBig;
    }
    if (!IS_BWD) {
      smn = t ? fminf(smn, lo) : lo;
      smx = t ? fmaxf(smx, hi) : hi;
    }
  }
  if constexpr (!FUSE) {
    // advect_sweep: u_w, u_mn, u_mx, s_plain [, s_num, s_den] [, s_mn,
    // s_mx on the forward sweep].
    constexpr int nx = 9 + (RENORM ? 3 : 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c * n] = acc[c];
      out[(3 + c) * n] = mn[c];
      out[(6 + c) * n] = mx[c];
    }
    out[9 * n] = plain;
    if (RENORM) {
      out[10 * n] = num;
      out[11 * n] = den;
    }
    if (!IS_BWD) {
      out[nx * n] = smn;
      out[(nx + 1) * n] = smx;
    }
    return;
  }

  float val = plain;
  if (RENORM && den > 1e-6f) val = num / den;

  if (!IS_BWD) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = (OURS && !fl) ? src.at(kU + c) : acc[c];
      out[c * n] = border ? 0.f : v;
      out[(3 + c) * n] = mn[c];
      out[(6 + c) * n] = mx[c];
    }
    if (OURS && !fl) val = src.at(kWS);
    out[9 * n] = border ? 0.f : val;
    out[10 * n] = smn;
    out[11 * n] = smx;
    return;
  }

  // Backward: MacCormack correction (MacCormackCorrectMAC,
  // tfluids.cc:660-699). Component c is skipped where the cell or its -c
  // neighbour is non-fluid; the neighbour counts as fluid at the low edge.
  const bool skip_ok[3] = {i == 0 || src.nb(kM, 0, 0, -1) > 0.5f,
                           j == 0 || src.nb(kM, 0, -1, 0) > 0.5f,
                           k == 0 || src.nb(kM, -1, 0, 0) > 0.5f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float fwd_c = src.at(kFU + c);
    float bwd_c = (OURS && !fl) ? fwd_c : acc[c];
    if (border) bwd_c = 0.f;
    const float uc = src.at(kU + c);
    const float corr = fwd_c + strength * 0.5f * (uc - bwd_c);
    out[c * n] = (fl && skip_ok[c]) ? corr : fwd_c;
    out[(3 + c) * n] = mn[c];
    out[(6 + c) * n] = mx[c];
  }
  const float fwd_sc = src.at(kWS);
  if (OURS && !fl) val = fwd_sc;
  const float bwd_s = border ? 0.f : val;
  out[9 * n] = fwd_sc + (fl ? strength * 0.5f * (src.s_at() - bwd_s) : 0.f);
}

// The output channels of a form.
template <bool IS_BWD, bool RENORM, bool SCALAR, bool FUSE>
__host__ __device__ constexpr int out_channels() {
  return FUSE ? (IS_BWD ? 10 : 12)
              : !SCALAR ? 9 : 9 + (RENORM ? 3 : 1) + (IS_BWD ? 0 : 2);
}

struct Args {
  const float *u, *s, *m, *fwd_u, *fwd_s, *fr;
  float* out;
  int B;
  Grid g;
  float dcoef, strength, lim;
  int zc;   // output planes a block (tiled route)
};

template <bool IS_BWD, bool OURS, bool RENORM, bool SCALAR, bool FUSE>
__global__ void __launch_bounds__(256)
mac_sweep_global(Args a) {
  const Grid g = a.g;
  const int n = g.Z * g.Y * g.X;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= a.B * n) return;
  const int b = gid / n;
  const int c0 = gid - b * n;
  const int i = c0 % g.X;
  const int j = (c0 / g.X) % g.Y;
  const int k = c0 / (g.X * g.Y);
  const float* U = a.u + (size_t)b * 3 * n;
  const float* FU = IS_BWD ? a.fwd_u + (size_t)b * 3 * n : U;
  const float* M = a.m + (size_t)b * n;
  const float* WS = IS_BWD ? a.fwd_s + (size_t)b * n : a.s + (size_t)b * n;
  const GlobalSrc src{{U, U + n, U + 2 * n, FU, FU + n, FU + 2 * n, WS, M},
                      a.s + (size_t)b * n,
                      a.fr + (size_t)b * n,
                      g, k, j, i, c0};
  constexpr int C = out_channels<IS_BWD, RENORM, SCALAR, FUSE>();
  sweep_cell<IS_BWD, OURS, RENORM, SCALAR, FUSE>(
      src, a.out + (size_t)b * C * n + c0, n, g, k, j, i, a.dcoef,
      a.strength, a.lim);
}

template <int W, int TY, bool IS_BWD, bool OURS, bool RENORM, bool SCALAR,
          bool FUSE>
__global__ void __launch_bounds__(kTX * TY)
mac_sweep_tiled(Args a) {
  using T = Ring<W, TY, IS_BWD, SCALAR>;
  extern __shared__ __align__(16) float sm[];
  const Grid g = a.g;
  const int n = g.Z * g.Y * g.X, yx = g.Y * g.X;
  const int t = threadIdx.x;
  const int ranges = (g.Z + a.zc - 1) / a.zc;
  const int b = blockIdx.z / ranges;
  const int zs = (blockIdx.z % ranges) * a.zc;
  const int ze = min(zs + a.zc, g.Z);
  const int ox = blockIdx.x * kTX - W, oy = blockIdx.y * TY - W;
  const int i = ox + W + t % kTX, j = oy + W + t / kTX;
  const bool active = i < g.X && j < g.Y;

  // Staged channel c of batch item b (c in shared-memory order).
  auto channel = [&](int c) {
    if (c < 3) return a.u + (b * 3 + c) * n;
    if (IS_BWD && c < 6) return a.fwd_u + (b * 3 + c - 3) * n;
    if (c == T::chan(kWS)) return (IS_BWD ? a.fwd_s : a.s) + b * n;
    return a.m + b * n;
  };
  // The plane cells this thread stages: their offsets in a plane.
  int off[T::PER];
  bool inxy[T::PER];
#pragma unroll
  for (int q = 0; q < T::PER; ++q) {
    const int r = t + q * T::kThreads;
    const int x = ox + r % T::SX, y = oy + r / T::SX;
    inxy[q] = r < T::P && x >= 0 && x < g.X && y >= 0 && y < g.Y;
    off[q] = inxy[q] ? y * g.X + x : 0;
  }
  // Requests plane p into ring slot q; zeros outside the domain.
  auto request = [&](int p, int q) {
    const bool inz = p >= 0 && p < g.Z;
    float* dst = sm + q * T::NC * T::P;
#pragma unroll
    for (int e = 0; e < T::PER; ++e) {
      const int r = t + e * T::kThreads;
      if (r < T::P) {
        const bool ok = inz && inxy[e];
        const int o = ok ? p * yx + off[e] : 0;
#pragma unroll
        for (int c = 0; c < T::NC; ++c)
          cp_async4(dst + c * T::P + r, channel(c) + o, ok);
      }
    }
  };

  // Planes zs - W .. ze + W - 1 are loaded, in order, one group each.
  const int p0 = zs - W, np = ze - zs + 2 * W;
  for (int r = 0; r < T::R - 1; ++r) {
    if (r < np) request(p0 + r, r);
    cp_async_commit();
  }
  const int cell = (t / kTX + W) * T::SX + t % kTX + W;
  constexpr int C = out_channels<IS_BWD, RENORM, SCALAR, FUSE>();
  float* out = a.out + b * C * n;
  int s0 = 0;   // the slot of plane k - W
  for (int k = zs; k < ze; ++k) {
    cp_async_wait<kAhead - 1>();   // plane k + W has landed
    __syncthreads();
    // Plane k + W + kAhead into the slot of plane k - W - 1, which step
    // k - 1 read last.
    if (k - zs + T::R - 1 < np)
      request(k + W + kAhead, s0 == 0 ? T::R - 1 : s0 - 1);
    cp_async_commit();
    if (active) {
      const int idx = (k * g.Y + j) * g.X + i;
      TileSrc<W, TY, IS_BWD, SCALAR> ts{
          sm, {}, k - W, oy, ox, cell, a.s + b * n + idx,
          a.fr + b * n + idx, g.Z, g.Y, g.X, g.z0};
#pragma unroll
      for (int e = 0; e <= 2 * W; ++e) {
        const int q = s0 + e;
        ts.base[e] = (q >= T::R ? q - T::R : q) * T::NC * T::P;
      }
      sweep_cell<IS_BWD, OURS, RENORM, SCALAR, FUSE>(
          ts, out + idx, n, g, k, j, i, a.dcoef, a.strength, a.lim);
    }
    s0 = s0 + 1 == T::R ? 0 : s0 + 1;
  }
}

// ty 0: the global kernel; else the tiled one with tile height ty and
// window W. occ != null: only reports the resident blocks an SM (tiled).
template <bool IS_BWD, bool OURS, bool RENORM, bool SCALAR, bool FUSE>
cudaError_t run(const Args& a, int W, int ty, int* occ, cudaStream_t st) {
  if (ty == 0) {
    if (occ) return cudaErrorInvalidValue;
    const int total = a.B * a.g.Z * a.g.Y * a.g.X;
    mac_sweep_global<IS_BWD, OURS, RENORM, SCALAR, FUSE>
        <<<(total + 255) / 256, 256, 0, st>>>(a);
    return cudaGetLastError();
  }
  void (*kern)(Args) = nullptr;
  int smem = 0;
#define FLUIDNET_K1_TILE(WW, TT)                                          \
  if (W == WW && ty == TT) {                                              \
    kern = mac_sweep_tiled<WW, TT, IS_BWD, OURS, RENORM, SCALAR, FUSE>;   \
    smem = Ring<WW, TT, IS_BWD, SCALAR>::kBytes;                          \
  }
  FLUIDNET_K1_TILE(1, 8)
  FLUIDNET_K1_TILE(1, 16)
  FLUIDNET_K1_TILE(2, 8)
  FLUIDNET_K1_TILE(2, 16)
#undef FLUIDNET_K1_TILE
  if (kern == nullptr || (!occ && a.zc < 1)) return cudaErrorInvalidValue;
  // Above 48 KB the launch needs the limit raised; the attribute belongs
  // to the function on the current device, so it is set every call.
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (occ)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, kTX * ty,
                                                         smem);
  const dim3 grid((a.g.X + kTX - 1) / kTX, (a.g.Y + ty - 1) / ty,
                  ((a.g.Z + a.zc - 1) / a.zc) * a.B);
  kern<<<grid, kTX * ty, smem, st>>>(a);
  return cudaGetLastError();
}

// The form: FUSE (fused epilogue, scalar), SCALAR (unfused with the
// scalar) or neither (velocity only; renorm ignored).
template <bool IS_BWD, bool OURS>
cudaError_t run_form(bool renorm, bool scalar, bool fuse, const Args& a,
                     int W, int ty, int* occ, cudaStream_t st) {
  if (fuse)
    return renorm ? run<IS_BWD, OURS, true, true, true>(a, W, ty, occ, st)
                  : run<IS_BWD, OURS, false, true, true>(a, W, ty, occ, st);
  if (scalar)
    return renorm ? run<IS_BWD, OURS, true, true, false>(a, W, ty, occ, st)
                  : run<IS_BWD, OURS, false, true, false>(a, W, ty, occ, st);
  return run<IS_BWD, OURS, false, false, false>(a, W, ty, occ, st);
}

cudaError_t dispatch(int is_bwd, int ours, int renorm, int scalar, int fuse,
                     const Args& a, int W, int ty, int* occ,
                     cudaStream_t st) {
  if (fuse && !scalar) return cudaErrorInvalidValue;
  if (is_bwd)
    return ours ? run_form<true, true>(renorm, scalar, fuse, a, W, ty, occ, st)
                : run_form<true, false>(renorm, scalar, fuse, a, W, ty, occ,
                                        st);
  return ours ? run_form<false, true>(renorm, scalar, fuse, a, W, ty, occ, st)
              : run_form<false, false>(renorm, scalar, fuse, a, W, ty, occ,
                                       st);
}

}  // namespace

// fuse != 0: out (B, 12, Z, Y, X) forward [u_w(3), u_mn(3), u_mx(3), s_val,
// s_mn, s_mx], (B, 10, Z, Y, X) backward [u_w(3) = corrected u, u_mn(3),
// u_mx(3), s_val = corrected s]; s and m always read, fwd_s backward.
// fuse == 0: the raw channels of mac_sweep.py:545-558, (B, 9, ...) without
// the scalar (s, m, fwd_s unread, may be null), else (B, 9 + (renorm ? 3 :
// 1) + (is_bwd ? 0 : 2), ...); s is read forward only. fwd_u/fwd_s are
// null on the forward sweep, free_space is null unless `ours`. z0: the
// global index of plane 0 (positions and BUILD_INDEX's z clamps are
// global; 0 for a whole grid). tile_y 0:
// the global route; 8 or 16: the tiled route (window 1 or 2) with `planes`
// output planes a block (ops/cuda/mac_sweep.py's sweep_tiling). Returns
// cudaGetLastError().
extern "C" int fluidnet_mac_sweep(const float* u, const float* s,
                                  const float* m, const float* fwd_u,
                                  const float* fwd_s, const float* free_space,
                                  float* out, int B, int Z, int Y, int X,
                                  int z0, float dcoef, float strength,
                                  float lim,
                                  int is_bwd, int ours, int renorm,
                                  int scalar, int fuse, int window,
                                  int tile_y, int planes, void* stream) {
  const Args a{u, s, m, fwd_u, fwd_s, free_space, out, B, Grid{Z, Y, X, z0},
               dcoef, strength, lim, planes};
  return static_cast<int>(dispatch(is_bwd, ours, renorm, scalar, fuse, a,
                                   window, tile_y, nullptr,
                                   static_cast<cudaStream_t>(stream)));
}

// The tiled route's resident blocks an SM for a form, window and tile
// height on the current device, into *blocks. Returns the CUDA error.
extern "C" int fluidnet_mac_sweep_occupancy(int is_bwd, int ours, int renorm,
                                            int scalar, int fuse, int window,
                                            int tile_y, int* blocks) {
  const Args a{};
  return static_cast<int>(dispatch(is_bwd, ours, renorm, scalar, fuse, a,
                                   window, tile_y, blocks, nullptr));
}
