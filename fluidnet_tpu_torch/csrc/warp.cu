// K5: the windowed warp (semi-Lagrangian interpolation of grouped fields).
//
// Replaces the TPU kernel fluidnet_tpu/ops/pallas/warp.py::_warp_group_kernel
// (_warp_group_impl): every interpolation of the 2-D advection
// (warp_group, warp_fluid, warp_trilinear[_shared], gather_cells). Fields
// come as (B, G, F, Z, Y, X), possibly split over several sources whose
// channels concatenate; the F channels of a group share one position set
// (B, G, Z, Y, X). Per output cell and group the kernel
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
// once each: 28 B/cell for F = 1 with min/max in 3-D (24 B in 2-D). The
// 2^d corner reads per channel are gathers that hit L1/L2 (the corners of
// neighbouring cells overlap). A few flops per corner and channel: far below
// the card's rate.
//
// Design (simple and right first): the TPU's roll-based tap window, z-blocks,
// 128-lane padding and clamped DMA are gone. One thread per output cell and
// group, x fastest, so a warp reads contiguous rows; corners gathered
// straight from global memory through the read-only path, no shared memory,
// no TMA. Source pointers arrive per channel, so multi-source calls need no
// concatenated copy (the TPU kernel DMAs each source separately for the same
// reason). Arithmetic follows the TPU kernel operation for operation (built
// with -fmad=false), so the kernel matches its plain PyTorch version
// (ops/warp.py::warp_group_plain) to the last bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxF = 8;
constexpr int kThreads = 256;

// Channel f of group (b, g) starts at base[f] + bg * stride[f]; the min/max
// channels (cmin, cmax) also at lo/hi + bg * lo_stride/hi_stride.
struct Chans {
  const float* base[kMaxF];
  long long stride[kMaxF];
  const float* lo;
  const float* hi;
  long long lo_stride, hi_stride;
};

struct Axis {
  int c[2];
  float w[2];
  bool ok[2];
};

__device__ __forceinline__ bool in_window(int c, int o, int W, int n) {
  return c >= o - W && c <= o + W && c >= 0 && c < n;
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

template <bool NEAREST, bool IS_3D, bool MINMAX>
__global__ void __launch_bounds__(kThreads)
warp_kernel(Chans ch, const float* __restrict__ px,
            const float* __restrict__ py, const float* __restrict__ pz,
            float* __restrict__ out, int total, int Z, int Y, int X, int W,
            int F, unsigned skip) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= total) return;
  const int nsp = Z * Y * X;
  const int bg = gid / nsp;
  const int c0 = gid - bg * nsp;
  const int i = c0 % X;
  const int j = (c0 / X) % Y;
  const int k = c0 / (X * Y);
  const int ncorner = NEAREST ? 1 : 2;

  const Axis ax = NEAREST ? nearest_axis(__ldg(px + gid), X, i, W)
                          : linear_axis(__ldg(px + gid), X, i, W);
  const Axis ay = NEAREST ? nearest_axis(__ldg(py + gid), Y, j, W)
                          : linear_axis(__ldg(py + gid), Y, j, W);
  Axis az;
  if (IS_3D) {
    az = NEAREST ? nearest_axis(__ldg(pz + gid), Z, k, W)
                 : linear_axis(__ldg(pz + gid), Z, k, W);
  } else {
    az.c[0] = az.c[1] = 0;
    az.w[0] = az.w[1] = 1.f;
    az.ok[0] = true;
    az.ok[1] = false;
  }
  const int nz = IS_3D ? ncorner : 1;

  const float* src[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f)
    src[f] = f < F ? ch.base[f] + (long long)bg * ch.stride[f] : nullptr;

  const float* lo = MINMAX ? ch.lo + (long long)bg * ch.lo_stride : nullptr;
  const float* hi = MINMAX ? ch.hi + (long long)bg * ch.hi_stride : nullptr;

  float acc[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) acc[f] = 0.f;
  float mn = INFINITY, mx = -INFINITY;

#pragma unroll
  for (int tz = 0; tz < nz; ++tz) {
#pragma unroll
    for (int ty = 0; ty < ncorner; ++ty) {
      const float wzy = az.w[tz] * ay.w[ty];
#pragma unroll
      for (int tx = 0; tx < ncorner; ++tx) {
        if (!(az.ok[tz] && ay.ok[ty] && ax.ok[tx])) continue;
        const float w = wzy * ax.w[tx];
        const int idx = (az.c[tz] * Y + ay.c[ty]) * X + ax.c[tx];
#pragma unroll
        for (int f = 0; f < kMaxF; ++f) {
          if (f < F && !((skip >> f) & 1u))
            acc[f] = acc[f] + __ldg(src[f] + idx) * w;
        }
        if (MINMAX) {
          mn = fminf(mn, __ldg(lo + idx));
          mx = fmaxf(mx, __ldg(hi + idx));
        }
      }
    }
  }

  const int Fo = F + (MINMAX ? 2 : 0);
  float* o = out + (long long)bg * Fo * nsp + c0;
#pragma unroll
  for (int f = 0; f < kMaxF; ++f)
    if (f < F) o[(long long)f * nsp] = acc[f];
  if (MINMAX) {
    o[(long long)F * nsp] = mn;
    o[(long long)(F + 1) * nsp] = mx;
  }
}

template <bool NEAREST, bool IS_3D>
void launch_minmax(bool minmax, dim3 grid, cudaStream_t st, const Chans& ch,
                   const float* px, const float* py, const float* pz,
                   float* out, int total, int Z, int Y, int X, int W, int F,
                   unsigned skip) {
  if (minmax)
    warp_kernel<NEAREST, IS_3D, true><<<grid, kThreads, 0, st>>>(
        ch, px, py, pz, out, total, Z, Y, X, W, F, skip);
  else
    warp_kernel<NEAREST, IS_3D, false><<<grid, kThreads, 0, st>>>(
        ch, px, py, pz, out, total, Z, Y, X, W, F, skip);
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
  Chans ch;
  int F = 0;
  for (int s = 0; s < n_src; ++s) {
    for (int fi = 0; fi < fs[s]; ++fi) {
      if (F >= kMaxF) return static_cast<int>(cudaErrorInvalidValue);
      ch.base[F] = srcs[s] + fi * nsp;
      ch.stride[F] = fs[s] * nsp;
      ++F;
    }
  }
  for (int f = F; f < kMaxF; ++f) {
    ch.base[f] = nullptr;
    ch.stride[f] = 0;
  }
  if (F == 0 || (nearest && minmax) ||
      (minmax && (cmin < 0 || cmin >= F || cmax < 0 || cmax >= F)))
    return static_cast<int>(cudaErrorInvalidValue);
  ch.lo = minmax ? ch.base[cmin] : nullptr;
  ch.hi = minmax ? ch.base[cmax] : nullptr;
  ch.lo_stride = minmax ? ch.stride[cmin] : 0;
  ch.hi_stride = minmax ? ch.stride[cmax] : 0;
  const unsigned skip =
      (minmax && skip_pair) ? ((1u << cmin) | (1u << cmax)) : 0u;
  const int total = B * G * Z * Y * X;
  const dim3 grid((total + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool is_3d = Z > 1;
  if (nearest) {
    if (is_3d)
      launch_minmax<true, true>(false, grid, st, ch, px, py, pz, out, total, Z,
                                Y, X, window, F, 0u);
    else
      launch_minmax<true, false>(false, grid, st, ch, px, py, pz, out, total,
                                 Z, Y, X, window, F, 0u);
  } else {
    if (is_3d)
      launch_minmax<false, true>(minmax != 0, grid, st, ch, px, py, pz, out,
                                 total, Z, Y, X, window, F, skip);
    else
      launch_minmax<false, false>(minmax != 0, grid, st, ch, px, py, pz, out,
                                  total, Z, Y, X, window, F, skip);
  }
  return static_cast<int>(cudaGetLastError());
}
