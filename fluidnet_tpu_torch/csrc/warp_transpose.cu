// K6: the adjoint of the windowed warp (the transposed interpolation).
//
// Replaces the TPU kernel
// fluidnet_tpu/ops/pallas/warp.py::_warp_transpose_kernel
// (_warp_transpose_pallas): the gradient of every windowed warp with respect
// to the warped fields, positions held fixed. It is the backward of K5
// (ops/warp.py::warp_group) and of K1's unfused sweeps (two launches per
// sweep: the three MAC components as G = 3 groups, the scalar as one group
// or, renormalised, as G = 2 over [plain, num]).
//
// g (B, G, F, Z, Y, X) is the cotangent of the warp's output, positions
// (B, G, Z, Y, X) are the warp's sample points (cell centres at i + 0.5).
// The forward warp gives output cell s the value sum_c w_c(s) f(c) over the
// corners c of its position; its adjoint is grad(t) = sum_s w_t(s) g(s).
// Written as a gather, with no atomics: one thread per target cell t and
// group sums, over the (2W+1)^d source offsets o = t - s in the order
// oz, oy, ox (each ascending), the term ((g(s) * wz) * wy) * wx, where
// w_a is the weight source s's corner along axis a gives t:
//   - linear, per axis (p = pos - 0.5, the BUILD_INDEX corners of
//     warp.py:_corner_weights): i = floor(p), w1 = p - i, w0 = 1 - w1; p < 0
//     gives corner 0 with weight 1; i >= n - 1 gives corners {n-2, n-1} with
//     weights {0, 1}; w(o) = w0 [i == s + o] + w1 [i + 1 == s + o];
//   - as the TPU kernel has it, along x and y the upper corner counts only
//     for o > -W (it is dropped when the base corner lies one below the
//     window), while along z it counts for every o in [-W, W]; the callers'
//     displacement clamp to +-(W - 1e-3) makes both rules unreachable;
//   - nearest (gather_cells): the one cell clip(floor(p), 0, n - 1), w = 1;
//   - 2-D (Z == 1): only the zero z-offset, no z weight.
// The sum is deterministic, and with -fmad=false it matches the plain
// PyTorch version (ops/cuda/warp_transpose.py) to the last bit.
//
// What bounds it on the H100: memory traffic, 20 B/cell per field group
// (3 positions and g in, the gradient out, F = 1). Each target reads the
// positions of its (2W+1)^d sources (27 in 3-D at W = 1) from L1/L2, and
// skips a source as soon as one axis weight is zero: most do, only the
// 2^d sources whose corners reach t load g.
//
// Design: simple and right first. No shared memory and no tap window: one
// thread per (target cell, group), x fastest so a warp reads contiguous
// rows, sources read straight from global memory through the read-only
// path.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxF = 8;
constexpr int kThreads = 256;

// Weight that the source at index s along one axis gives the target
// t = s + o.
template <bool NEAREST, bool KEEP_LOW>
__device__ __forceinline__ float tap(float pos, int n, int s, int o, int W) {
  const float p = pos - 0.5f;
  const float fi = floorf(p);
  if (NEAREST) {
    const int i = min(max(static_cast<int>(fi), 0), n - 1);
    return i == s + o ? 1.f : 0.f;
  }
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
  const float ind0 = i == s + o ? 1.f : 0.f;
  const float ind1 = (KEEP_LOW || o > -W) && i + 1 == s + o ? 1.f : 0.f;
  return w0 * ind0 + w1 * ind1;
}

template <bool NEAREST, bool IS_3D>
__global__ void __launch_bounds__(kThreads)
warp_transpose_kernel(const float* __restrict__ g, const float* __restrict__ px,
                      const float* __restrict__ py,
                      const float* __restrict__ pz, float* __restrict__ out,
                      int total, int Z, int Y, int X, int W, int F) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= total) return;
  const int nsp = Z * Y * X;
  const int bg = gid / nsp;
  const int c0 = gid - bg * nsp;
  const int tx = c0 % X;
  const int ty = (c0 / X) % Y;
  const int tz = c0 / (X * Y);
  const float* P[3] = {px + (long long)bg * nsp, py + (long long)bg * nsp,
                       pz + (long long)bg * nsp};
  const float* G = g + (long long)bg * F * nsp;

  float acc[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) acc[f] = 0.f;

  const int wz_lo = IS_3D ? -W : 0, wz_hi = IS_3D ? W : 0;
  for (int oz = wz_lo; oz <= wz_hi; ++oz) {
    const int sz = tz - oz;
    if (sz < 0 || sz >= Z) continue;
    for (int oy = -W; oy <= W; ++oy) {
      const int sy = ty - oy;
      if (sy < 0 || sy >= Y) continue;
      for (int ox = -W; ox <= W; ++ox) {
        const int sx = tx - ox;
        if (sx < 0 || sx >= X) continue;
        const int s = (sz * Y + sy) * X + sx;
        float wz = 1.f;
        if (IS_3D) {
          wz = tap<NEAREST, true>(__ldg(P[2] + s), Z, sz, oz, W);
          if (wz == 0.f) continue;
        }
        const float wy = tap<NEAREST, false>(__ldg(P[1] + s), Y, sy, oy, W);
        if (wy == 0.f) continue;
        const float wx = tap<NEAREST, false>(__ldg(P[0] + s), X, sx, ox, W);
        if (wx == 0.f) continue;
#pragma unroll
        for (int f = 0; f < kMaxF; ++f) {
          if (f < F) {
            const float v = __ldg(G + (long long)f * nsp + s);
            acc[f] = acc[f] + (IS_3D ? ((v * wz) * wy) * wx : (v * wy) * wx);
          }
        }
      }
    }
  }
  float* o = out + (long long)bg * F * nsp + c0;
#pragma unroll
  for (int f = 0; f < kMaxF; ++f)
    if (f < F) o[(long long)f * nsp] = acc[f];
}

template <bool NEAREST>
void launch(bool is_3d, dim3 grid, cudaStream_t st, const float* g,
            const float* px, const float* py, const float* pz, float* out,
            int total, int Z, int Y, int X, int W, int F) {
  if (is_3d)
    warp_transpose_kernel<NEAREST, true><<<grid, kThreads, 0, st>>>(
        g, px, py, pz, out, total, Z, Y, X, W, F);
  else
    warp_transpose_kernel<NEAREST, false><<<grid, kThreads, 0, st>>>(
        g, px, py, pz, out, total, Z, Y, X, W, F);
}

}  // namespace

// g, out (B, G, F, Z, Y, X); px/py/pz (B, G, Z, Y, X), pz read only when
// Z > 1. F in [1, 8]. Returns cudaGetLastError().
extern "C" int fluidnet_warp_transpose(const float* g, const float* px,
                                       const float* py, const float* pz,
                                       float* out, int B, int G, int F, int Z,
                                       int Y, int X, int window, int nearest,
                                       void* stream) {
  if (F < 1 || F > kMaxF || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = B * G * Z * Y * X;
  const dim3 grid((total + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nearest)
    launch<true>(Z > 1, grid, st, g, px, py, pz, out, total, Z, Y, X, window,
                 F);
  else
    launch<false>(Z > 1, grid, st, g, px, py, pz, out, total, Z, Y, X, window,
                  F);
  return static_cast<int>(cudaGetLastError());
}
