// K5: the windowed warp (semi-Lagrangian interpolation of grouped fields).
//
// Replaces the TPU kernel fluidnet_tpu/ops/pallas/warp.py::_warp_group_kernel
// (_warp_group_impl): every interpolation of the 2-D advection
// (warp_group, warp_fluid, warp_trilinear[_shared], gather_cells) and of the
// 3-D density on the unfused paths. Fields come as (B, G, F, Z, Y, X),
// possibly split over several sources whose channels concatenate; the F
// channels of a group share one position set (B, G, Z, Y, X). Per output
// cell and group the kernel
//   1. takes, per axis, p = pos - 0.5 and the BUILD_INDEX corners
//      (warp.py:84-94): i = floor(p), w1 = p - i, w0 = 1 - w1; p < 0 gives
//      corner 0 with weight 1; i >= n - 1 gives corners {n-2, n-1} with
//      weights {0, 1}. Nearest mode (gather_cells) takes the one cell
//      clip(floor(p), 0, n - 1) with weight 1. Z == 1 is the 2-D case: only
//      the zero z-offset, weight 1;
//   2. drops a corner more than W cells from the output cell on any axis,
//      and the upper corner i + 1 whenever the base corner i is dropped
//      (the TPU kernel's (2W+1)^d tap window, warp.py:95-101; the callers'
//      displacement clamp makes both unreachable), and any corner outside
//      the grid, so no read leaves it;
//   3. accumulates every channel over the corners in the TPU kernel's order
//      (z, then y, then x, each ascending): acc += v * ((wz * wy) * wx);
//   4. with min/max, tracks min of channel cmin and max of channel cmax over
//      the support {i, i+1}^d, zero-weight corners included, from +-inf.
//      With a (cmin, cmax) pair those two channels are bound sources
//      carrying +-1e30 sentinels: they are never accumulated and are
//      written out as zeros, the TPU kernel's output layout.
// Output (B, G, F [+2], Z, Y, X): the channels, then min and max.
//
// What bounds it on the H100: memory traffic. Compulsory traffic is the
// positions (2 or 3 floats), the F source channels and the F [+2] outputs,
// once each: 28 B/cell for F = 1 with min/max in 3-D (24 B in 2-D). A few
// flops per corner and channel: far below the card's rate, and no product
// for the tensor cores.
//
// Design. One thread per output cell. Every corner value is loaded once
// per channel: min and max take the values the sums loaded, and a (cmin,
// cmax) pair of bound sources is read through its own pointers, once each,
// never accumulated. An uncounted corner is left out by selects, not by a
// divergent branch. In 2-D (the 128^2 server: a call is a few
// microseconds, one chain of dependent loads per thread, the grid in
// L1/L2) every corner value is loaded before the first is used, so the
// loads' latencies overlap. In 3-D, 8 corners times F channels held at
// once cost registers and occupancy, so each value is loaded where it is
// summed; a shared-memory tile of the sources plus the window's halo
// (which the window makes exact) timed no faster than this at 128^3.
// Source pointers arrive per channel, so multi-source calls need no
// concatenated copy (the TPU kernel DMAs each source separately for the same
// reason). Arithmetic follows the TPU kernel operation for operation (built
// with -fmad=false), so the kernel matches its plain PyTorch version
// (ops/warp.py::warp_group_plain) to the last bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxF = 8;
constexpr int kThreads = 256;

// Channel f of group (b, g) starts at base[f] + bg * stride[f]; the min
// and max channels (cmin, cmax) also at lo/hi + bg * lo_stride/hi_stride.
struct Chans {
  const float* base[kMaxF];
  long long stride[kMaxF];
  const float* lo;
  const float* hi;
  long long lo_stride, hi_stride;
};

// Min/max modes: none; of channels cmin and cmax, which are accumulated
// too (their loaded values are reused); of a (cmin, cmax) pair of bound
// sources, loaded once each and never accumulated.
enum MinMax { kNone = 0, kOfChannels = 1, kOfPair = 2 };

struct Axis {
  int c[2];
  float w[2];
  bool ok[2];
};

// |c - o| <= W and 0 <= c < n.
__device__ __forceinline__ bool in_window(int c, int o, int W, int n) {
  return static_cast<unsigned>(c - o + W) <= static_cast<unsigned>(2 * W) &&
         static_cast<unsigned>(c) < static_cast<unsigned>(n);
}

// BUILD_INDEX corners of one axis (warp.py:_corner_weights).
__device__ __forceinline__ Axis linear_axis(float pos, int n, int o, int W) {
  const float p = pos - 0.5f;
  const float fi = floorf(p);
  Axis a;
  int i = static_cast<int>(fi);
  float w1 = p - fi;
  float w0 = 1.f - w1;
  if (p < 0.f) {
    i = 0;
    w0 = 1.f;
    w1 = 0.f;
  }
  if (i >= n - 1) {
    i = n - 2;
    w0 = 0.f;
    w1 = 1.f;
  }
  a.c[0] = i;
  a.c[1] = i + 1;
  a.w[0] = w0;
  a.w[1] = w1;
  // The TPU kernel's taps o in [-W, W] carry corner i at o = i - x and
  // corner i + 1 at o = i + 1 - x only for o > -W: the upper corner counts
  // only while the base corner is in the window too.
  a.ok[0] = in_window(i, o, W, n);
  a.ok[1] = a.ok[0] && in_window(i + 1, o, W, n);
  return a;
}

// The one cell of nearest mode (warp.py:_nearest_weights).
__device__ __forceinline__ Axis nearest_axis(float pos, int n, int o, int W) {
  Axis a;
  int i = static_cast<int>(floorf(pos - 0.5f));
  i = min(max(i, 0), n - 1);
  a.c[0] = a.c[1] = i;
  a.w[0] = a.w[1] = 1.f;
  a.ok[0] = in_window(i, o, W, n);
  a.ok[1] = false;
  return a;
}

template <bool NEAREST>
__device__ __forceinline__ Axis axis(float pos, int n, int o, int W) {
  return NEAREST ? nearest_axis(pos, n, o, W) : linear_axis(pos, n, o, W);
}

__device__ __forceinline__ Axis flat_axis() {
  Axis a;
  a.c[0] = a.c[1] = 0;
  a.w[0] = a.w[1] = 1.f;
  a.ok[0] = true;
  a.ok[1] = false;
  return a;
}

// The 2^d corners of one output cell, in the summation order (z, y, x
// ascending): where corner c is (off[c], its element offset in a plane of
// Y x X rows), its weight (wz * wy) * wx and whether it counts.
template <bool NEAREST, bool IS_3D>
struct Corners {
  static constexpr int kN = NEAREST ? 1 : (IS_3D ? 8 : 4);
  int off[kN];
  float w[kN];
  bool ok[kN];

  __device__ __forceinline__ Corners(const Axis& az, const Axis& ay,
                                     const Axis& ax, int Y, int X) {
    const int nc = NEAREST ? 1 : 2;
    const int nz = IS_3D ? nc : 1;
#pragma unroll
    for (int tz = 0; tz < nz; ++tz) {
#pragma unroll
      for (int ty = 0; ty < nc; ++ty) {
        const float wzy = az.w[tz] * ay.w[ty];
#pragma unroll
        for (int tx = 0; tx < nc; ++tx) {
          const int c = (tz * nc + ty) * nc + tx;
          ok[c] = az.ok[tz] && ay.ok[ty] && ax.ok[tx];
          w[c] = wzy * ax.w[tx];
          off[c] = (az.c[tz] * Y + ay.c[ty]) * X + ax.c[tx];
        }
      }
    }
  }
};

// The sums over the corners (acc += v * w in corner order) and min/max
// over the counted corners (mode MM). Every corner value is loaded once
// per channel (an uncounted corner reads the plane's first cell, then
// selects leave it out: no divergent branch); with PRELOAD all of them
// before the first is used. load(f, off) reads channel f at a corner
// offset, bound(j, off) the pair's min (j = 0) or max (j = 1) source,
// out(f) is where result f goes (f < F + 2).
template <int MM, bool PRELOAD, typename CornersT, typename Load,
          typename Bound, typename Out>
__device__ __forceinline__ void interpolate(const CornersT& cs, int F,
                                            unsigned skip, int cmin,
                                            int cmax, Load load, Bound bound,
                                            Out out) {
  constexpr int N = CornersT::kN;
  float v[N][kMaxF], b[N][2];
  int off[N];
#pragma unroll
  for (int c = 0; c < N; ++c) off[c] = cs.ok[c] ? cs.off[c] : 0;
  if (PRELOAD) {
#pragma unroll
    for (int f = 0; f < kMaxF; ++f)
      if (f < F && !((skip >> f) & 1u))
#pragma unroll
        for (int c = 0; c < N; ++c) v[c][f] = load(f, off[c]);
    if (MM == kOfPair)
#pragma unroll
      for (int c = 0; c < N; ++c) {
        b[c][0] = bound(0, off[c]);
        b[c][1] = bound(1, off[c]);
      }
  }
  float mn = INFINITY, mx = -INFINITY;
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) {
    if (f >= F) continue;
    float acc = 0.f;
    if (!((skip >> f) & 1u)) {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        if (!PRELOAD) v[c][f] = load(f, off[c]);
        const float sum = acc + v[c][f] * cs.w[c];
        acc = cs.ok[c] ? sum : acc;
        if (MM == kOfChannels) {
          mn = cs.ok[c] && f == cmin ? fminf(mn, v[c][f]) : mn;
          mx = cs.ok[c] && f == cmax ? fmaxf(mx, v[c][f]) : mx;
        }
      }
    }
    *out(f) = acc;
  }
  if (MM == kOfPair) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (!PRELOAD) {
        b[c][0] = bound(0, off[c]);
        b[c][1] = bound(1, off[c]);
      }
      mn = cs.ok[c] ? fminf(mn, b[c][0]) : mn;
      mx = cs.ok[c] ? fmaxf(mx, b[c][1]) : mx;
    }
  }
  if (MM != kNone) {
    *out(F) = mn;
    *out(F + 1) = mx;
  }
}

template <bool NEAREST, bool IS_3D, int MM>
__global__ void __launch_bounds__(kThreads)
warp_direct(Chans ch, const float* __restrict__ px,
            const float* __restrict__ py, const float* __restrict__ pz,
            float* __restrict__ out, int total, int Z, int Y, int X, int W,
            int F, unsigned skip, int cmin, int cmax) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= total) return;
  const int nsp = Z * Y * X;
  const int bg = gid / nsp;
  const int c0 = gid - bg * nsp;
  const int i = c0 % X;
  const int j = (c0 / X) % Y;
  const int k = c0 / (X * Y);
  const Axis ax = axis<NEAREST>(__ldg(px + gid), X, i, W);
  const Axis ay = axis<NEAREST>(__ldg(py + gid), Y, j, W);
  const Axis az =
      IS_3D ? axis<NEAREST>(__ldg(pz + gid), Z, k, W) : flat_axis();
  const Corners<NEAREST, IS_3D> cs(az, ay, ax, Y, X);
  const int Fo = F + (MM != kNone ? 2 : 0);
  float* o = out + (long long)bg * Fo * nsp + c0;
  interpolate<MM, !IS_3D>(
      cs, F, skip, cmin, cmax,
      [&](int f, int off) {
        return __ldg(ch.base[f] + (long long)bg * ch.stride[f] + off);
      },
      [&](int j, int off) {
        return __ldg(j ? ch.hi + (long long)bg * ch.hi_stride + off
                       : ch.lo + (long long)bg * ch.lo_stride + off);
      },
      [&](int f) { return o + (long long)f * nsp; });
}

struct Args {
  Chans ch;
  const float *px, *py, *pz;
  float* out;
  int B, G, Z, Y, X, W, F;
  unsigned skip;
  int cmin, cmax;
};

template <bool NEAREST, bool IS_3D, int MM>
void launch(const Args& a, cudaStream_t st) {
  const int total = a.B * a.G * a.Z * a.Y * a.X;
  warp_direct<NEAREST, IS_3D, MM>
      <<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          a.ch, a.px, a.py, a.pz, a.out, total, a.Z, a.Y, a.X, a.W, a.F,
          a.skip, a.cmin, a.cmax);
}

template <bool IS_3D>
void launch_mode(bool nearest, int mm, const Args& a, cudaStream_t st) {
  if (nearest)
    launch<true, IS_3D, kNone>(a, st);
  else if (mm == kOfPair)
    launch<false, IS_3D, kOfPair>(a, st);
  else if (mm == kOfChannels)
    launch<false, IS_3D, kOfChannels>(a, st);
  else
    launch<false, IS_3D, kNone>(a, st);
}

}  // namespace

// srcs: host array of n_src device pointers, source s of shape
// (B, G, fs[s], Z, Y, X); the channels concatenate in source order (at most
// 8 in all). px/py/pz (B, G, Z, Y, X); pz is read only when Z > 1. out
// (B, G, F [+2], Z, Y, X). minmax: 0 none, 1 min of channel cmin and max of
// channel cmax (skip_pair: those two channels are bound sources, not
// accumulated). Nearest mode takes no min/max. Returns cudaGetLastError().
extern "C" int fluidnet_warp(const float* const* srcs, const int* fs,
                             int n_src, const float* px, const float* py,
                             const float* pz, float* out, int B, int G, int Z,
                             int Y, int X, int window, int nearest, int minmax,
                             int cmin, int cmax, int skip_pair,
                             void* stream) {
  const long long nsp = (long long)Z * Y * X;
  Args a;
  int F = 0;
  for (int s = 0; s < n_src; ++s) {
    for (int fi = 0; fi < fs[s]; ++fi) {
      if (F >= kMaxF) return static_cast<int>(cudaErrorInvalidValue);
      a.ch.base[F] = srcs[s] + fi * nsp;
      a.ch.stride[F] = fs[s] * nsp;
      ++F;
    }
  }
  for (int f = F; f < kMaxF; ++f) {
    a.ch.base[f] = nullptr;
    a.ch.stride[f] = 0;
  }
  if (F == 0 || window < 1 || (nearest && minmax) ||
      (minmax && (cmin < 0 || cmin >= F || cmax < 0 || cmax >= F)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.ch.lo = minmax ? a.ch.base[cmin] : nullptr;
  a.ch.hi = minmax ? a.ch.base[cmax] : nullptr;
  a.ch.lo_stride = minmax ? a.ch.stride[cmin] : 0;
  a.ch.hi_stride = minmax ? a.ch.stride[cmax] : 0;
  a.px = px;
  a.py = py;
  a.pz = pz;
  a.out = out;
  a.B = B;
  a.G = G;
  a.Z = Z;
  a.Y = Y;
  a.X = X;
  a.W = window;
  a.F = F;
  a.skip = (minmax && skip_pair) ? ((1u << cmin) | (1u << cmax)) : 0u;
  a.cmin = minmax ? cmin : -1;
  a.cmax = minmax ? cmax : -1;
  const int mm = !minmax ? kNone : skip_pair ? kOfPair : kOfChannels;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Z > 1)
    launch_mode<true>(nearest != 0, mm, a, st);
  else
    launch_mode<false>(nearest != 0, mm, a, st);
  return static_cast<int>(cudaGetLastError());
}
