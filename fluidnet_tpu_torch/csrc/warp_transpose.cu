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
// With no atomics, each target cell t and group sums, over the (2W+1)^d
// source offsets o = t - s in the order oz, oy, ox (each ascending), the
// term ((g(s) * wz) * wy) * wx, where w_a is the weight source s's corner
// along axis a gives t:
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
// A term of zero weight is not added (adding it would not change the sum).
// The sum is deterministic, and with -fmad=false it matches the plain
// PyTorch version (ops/cuda/warp_transpose.py) to the last bit.
//
// What bounds it on the H100: memory traffic, 20 B/cell per field group
// (3 positions and g in, the gradient out, F = 1). The arithmetic is a
// weight product per (source, target) pair that a corner joins, 2^d per
// source. There is no product for the tensor cores (wgmma) to take.
//
// Design, for W = 1 and 2: the window makes a tile exact. A source more
// than W cells from a target gives it nothing, so a block that owns a
// 32 x 8 x-y tile of targets needs only the sources of that tile plus a W
// halo. It marches down a chunk of z slices; source slice k, copied into
// shared memory with cp.async two slices ahead, is decomposed once per
// source (per axis, the base corner's offset and w1) and pushed: each
// source writes each of its nonzero terms into the shared-memory slot that
// belongs to (target, offset) - one writer per slot, so no atomics. Each
// thread then adds its own target's (oy, ox) slots of slice k, in order,
// to the running sums of target slices k - W .. k + W, held in registers,
// and zeroes them. Marching down, target slice tz meets its source slices
// tz + W, ..., tz - W, i.e. its offsets oz in ascending order: the sum runs
// in the plain version's order, and target slice k + W is complete after
// slice k. Sources outside the grid are never loaded. The z extent is cut
// into chunks so that ~1024 blocks fill the 132 SMs. Wider windows, whose
// slots would not fit in shared memory, take the direct kernel: one thread
// per target reading its (2W+1)^d sources from global memory, in the same
// order.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxF = 8;
constexpr int kThreads = 256;
constexpr int kTX = 32, kTY = kThreads / kTX;   // a block's tile of targets
constexpr int kAhead = 2;            // source slices in flight
constexpr int kTargetBlocks = 1024;
constexpr int kMinChunk = 8;         // z slices a block marches through

// The BUILD_INDEX decomposition of one source along one axis: the base
// corner i relative to the source index s, clamped into [-W - 2, W + 1]
// (outside that range neither corner reaches an offset in [-W, W]), and w1.
template <bool NEAREST>
__device__ __forceinline__ int decompose(float pos, int n, int s, int W,
                                         float* w1_out) {
  const float p = pos - 0.5f;
  const float fi = floorf(p);
  int i;
  float w1 = 0.f;
  if (NEAREST) {
    i = min(max(static_cast<int>(fi), 0), n - 1);
  } else {
    i = static_cast<int>(fi);
    w1 = p - fi;
    if (p < 0.f) {
      i = 0;
      w1 = 0.f;
    }
    if (i >= n - 1) {
      i = n - 2;
      w1 = 1.f;
    }
  }
  *w1_out = w1;
  return min(max(i - s, -W - 2), W + 1);
}

// Weight that a source with base-corner offset d0 and upper weight w1
// gives the target at offset o (the plain version's tap): w0 = 1 - w1 for
// the base corner, w1 for the upper one (along x and y only for o > -W).
template <bool NEAREST, bool KEEP_LOW>
__device__ __forceinline__ float weight(int d0, float w1, int o, int W) {
  if (d0 == o) return NEAREST ? 1.f : 1.f - w1;
  if (!NEAREST && d0 + 1 == o && (KEEP_LOW || o > -W)) return w1;
  return 0.f;
}

// One staged source along one axis: its base-corner offset and w1.
struct Tap {
  int d0;
  float w1;
};

template <int W, bool NEAREST, bool IS_3D>
__global__ void __launch_bounds__(kThreads)
warp_transpose_tiled(const float* __restrict__ g,
                     const float* __restrict__ px,
                     const float* __restrict__ py,
                     const float* __restrict__ pz, float* __restrict__ out,
                     int Z, int Y, int X, int F, int tiles_x, int zchunk) {
  extern __shared__ float smem[];
  constexpr int WZ = IS_3D ? W : 0;
  constexpr int NO = 2 * W + 1, NZ = 2 * WZ + 1, NE = NEAREST ? 1 : 2;
  constexpr int SX = kTX + 2 * W, S = SX * (kTY + 2 * W);
  constexpr int PER = (S + kThreads - 1) / kThreads;   // sources a thread
  constexpr int RAW = kAhead + 1;
  // The terms of the source slice being pushed: term[oz][oy][ox][target],
  // the target's slot for each offset (one channel), then RAW staging
  // slots of S-word planes: the positions x, y, z and g's F channels.
  float* term = smem;
  float* raw = smem + NZ * NO * NO * kThreads;
  const int slot_words = (3 + F) * S;

  const int tx0 = (blockIdx.x % tiles_x) * kTX;
  const int ty0 = (blockIdx.x / tiles_x) * kTY;
  const int z0 = blockIdx.y * zchunk, z1 = min(z0 + zchunk, Z);
  const long long nsp = (long long)Z * Y * X;
  const long long bg = blockIdx.z;
  const int k_hi = z1 - 1 + WZ, k_lo = z0 - WZ;
  auto slot = [&](int k) { return raw + (k_hi - k) % RAW * slot_words; };

  // Starts the copies of source slice k (the tile and its halo, cells in
  // the grid only).
  auto fetch_slice = [&](int k) {
    if (k < 0 || k >= Z || k < k_lo) return;
    float* base = slot(k);
    for (int r = threadIdx.x; r < S; r += kThreads) {
      const int x = tx0 - W + r % SX, y = ty0 - W + r / SX;
      if (x < 0 || x >= X || y < 0 || y >= Y) continue;
      const long long sp = ((long long)k * Y + y) * X + x;
      const long long c = bg * nsp + sp;
      __pipeline_memcpy_async(base + r, px + c, sizeof(float));
      __pipeline_memcpy_async(base + S + r, py + c, sizeof(float));
      if (IS_3D) __pipeline_memcpy_async(base + 2 * S + r, pz + c,
                                         sizeof(float));
      const float* gc = g + bg * F * nsp + sp;
#pragma unroll
      for (int f = 0; f < kMaxF; ++f)
        if (f < F)
          __pipeline_memcpy_async(base + (3 + f) * S + r, gc + f * nsp,
                                  sizeof(float));
    }
  };

  // acc[m][f]: the open target slices k - W + m, m = 0..2W, of this
  // thread's target column; each thread zeroes its own term slots.
  float acc[NZ][kMaxF];
#pragma unroll
  for (int m = 0; m < NZ; ++m)
#pragma unroll
    for (int f = 0; f < kMaxF; ++f) acc[m][f] = 0.f;
#pragma unroll
  for (int i = 0; i < NZ * NO * NO; ++i) term[i * kThreads + threadIdx.x] = 0.f;
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    fetch_slice(k_hi - j);
    __pipeline_commit();
  }
  const int tx = tx0 + threadIdx.x % kTX, ty = ty0 + threadIdx.x / kTX;

  // Down the chunk: target slice tz takes source slice k = tz - oz at
  // offset oz, so descending k brings its offsets in ascending order.
  for (int k = k_hi; k >= k_lo; --k) {
    __pipeline_wait_prior(kAhead - 1);
    __syncthreads();
    // Slice k has landed; slice k - kAhead goes to the slot of slice
    // k + 1, pushed in the last step.
    fetch_slice(k - kAhead);
    __pipeline_commit();
    const bool have = k >= 0 && k < Z;
    const float* base = slot(k);
    Tap t[PER][3];
    bool in[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int r = threadIdx.x + q * kThreads;
      const int x = tx0 - W + r % SX, y = ty0 - W + r / SX;
      in[q] = have && r < S && x >= 0 && x < X && y >= 0 && y < Y;
      if (!in[q]) continue;
      t[q][0].d0 = decompose<NEAREST>(base[r], X, x, W, &t[q][0].w1);
      t[q][1].d0 = decompose<NEAREST>(base[S + r], Y, y, W, &t[q][1].w1);
      if (IS_3D)
        t[q][2].d0 = decompose<NEAREST>(base[2 * S + r], Z, k, W,
                                        &t[q][2].w1);
    }
#pragma unroll
    for (int f = 0; f < kMaxF; ++f) {
      if (f >= F || !have) continue;
      if (f > 0) __syncthreads();   // channel f - 1's slots are zero again
      // Push: each source writes its nonzero terms into the slots of the
      // targets of this tile it reaches.
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        if (!in[q]) continue;
        const int r = threadIdx.x + q * kThreads;
        const float v = base[(3 + f) * S + r];
#pragma unroll
        for (int ez = 0; ez < (IS_3D ? NE : 1); ++ez) {
          const int oz = IS_3D ? t[q][2].d0 + ez : 0;
          const float wz =
              IS_3D ? weight<NEAREST, true>(t[q][2].d0, t[q][2].w1, oz, W)
                    : 1.f;
          if (oz < -WZ || oz > WZ || wz == 0.f) continue;
#pragma unroll
          for (int ey = 0; ey < NE; ++ey) {
            const int oy = t[q][1].d0 + ey;
            const int ly = r / SX - W + oy;
            const float wy =
                weight<NEAREST, false>(t[q][1].d0, t[q][1].w1, oy, W);
            if (oy < -W || oy > W || ly < 0 || ly >= kTY || wy == 0.f)
              continue;
#pragma unroll
            for (int ex = 0; ex < NE; ++ex) {
              const int ox = t[q][0].d0 + ex;
              const int lx = r % SX - W + ox;
              const float wx =
                  weight<NEAREST, false>(t[q][0].d0, t[q][0].w1, ox, W);
              if (ox < -W || ox > W || lx < 0 || lx >= kTX || wx == 0.f)
                continue;
              term[(((oz + WZ) * NO + oy + W) * NO + ox + W) * kThreads +
                   ly * kTX + lx] =
                  IS_3D ? ((v * wz) * wy) * wx : (v * wy) * wx;
            }
          }
        }
      }
      __syncthreads();
      // Sum: target slice k + oz adds its slots of offset oz, (oy, ox)
      // ascending, and zeroes them.
#pragma unroll
      for (int m = 0; m < NZ; ++m) {
#pragma unroll
        for (int i = 0; i < NO * NO; ++i) {
          float* slot_i = term + (m * NO * NO + i) * kThreads + threadIdx.x;
          acc[m][f] = acc[m][f] + *slot_i;
          *slot_i = 0.f;
        }
      }
    }
    // Target slice k + W has all its offsets: store it, and open k - W - 1.
    const int tz = k + WZ;
    if (tz >= z0 && tz < z1 && tx < X && ty < Y) {
      float* o = out + bg * F * nsp + ((long long)tz * Y + ty) * X + tx;
#pragma unroll
      for (int f = 0; f < kMaxF; ++f)
        if (f < F) o[(long long)f * nsp] = acc[NZ - 1][f];
    }
#pragma unroll
    for (int m = NZ - 1; m > 0; --m)
#pragma unroll
      for (int f = 0; f < kMaxF; ++f) acc[m][f] = acc[m - 1][f];
#pragma unroll
    for (int f = 0; f < kMaxF; ++f) acc[0][f] = 0.f;
  }
}

// Weight of one axis recomputed from the position (the direct kernel).
template <bool NEAREST, bool KEEP_LOW>
__device__ __forceinline__ float tap(float pos, int n, int s, int o, int W) {
  float w1;
  const int d0 = decompose<NEAREST>(pos, n, s, W, &w1);
  return weight<NEAREST, KEEP_LOW>(d0, w1, o, W);
}

template <bool NEAREST, bool IS_3D>
__global__ void __launch_bounds__(kThreads)
warp_transpose_direct(const float* __restrict__ g,
                      const float* __restrict__ px,
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

struct Args {
  const float *g, *px, *py, *pz;
  float* out;
  int B, G, F, Z, Y, X, W;
};

template <int W, bool NEAREST, bool IS_3D>
cudaError_t launch_tiled(const Args& a, cudaStream_t st) {
  constexpr int WZ = IS_3D ? W : 0;
  constexpr int S = (kTX + 2 * W) * (kTY + 2 * W);
  constexpr int TERMS = (2 * WZ + 1) * (2 * W + 1) * (2 * W + 1) * kThreads;
  const int tiles_x = (a.X + kTX - 1) / kTX;
  const int tiles = tiles_x * ((a.Y + kTY - 1) / kTY);
  // Cut z into chunks of at least kMinChunk slices until ~kTargetBlocks
  // blocks.
  const int want = (kTargetBlocks + tiles * a.B * a.G - 1) /
                   (tiles * a.B * a.G);
  int chunks = max(1, min(want, a.Z / kMinChunk));
  const int zchunk = (a.Z + chunks - 1) / chunks;
  chunks = (a.Z + zchunk - 1) / zchunk;
  const size_t smem =
      sizeof(float) * (TERMS + (kAhead + 1) * (3 + a.F) * S);
  // Above 48 KB the launch needs the limit raised; the attribute belongs
  // to the function on the current device, so it is set every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      warp_transpose_tiled<W, NEAREST, IS_3D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, chunks, a.B * a.G);
  warp_transpose_tiled<W, NEAREST, IS_3D><<<grid, kThreads, smem, st>>>(
      a.g, a.px, a.py, a.pz, a.out, a.Z, a.Y, a.X, a.F, tiles_x, zchunk);
  return cudaGetLastError();
}

template <bool NEAREST, bool IS_3D>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if (a.B * a.G <= 65535 && a.W == 1)
    return launch_tiled<1, NEAREST, IS_3D>(a, st);
  if (a.B * a.G <= 65535 && a.W == 2)
    return launch_tiled<2, NEAREST, IS_3D>(a, st);
  const int total = a.B * a.G * a.Z * a.Y * a.X;
  warp_transpose_direct<NEAREST, IS_3D>
      <<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          a.g, a.px, a.py, a.pz, a.out, total, a.Z, a.Y, a.X, a.W, a.F);
  return cudaGetLastError();
}

}  // namespace

// g, out (B, G, F, Z, Y, X); px/py/pz (B, G, Z, Y, X), pz read only when
// Z > 1. F in [1, 8]. Returns the first CUDA error of the launch, or 0.
extern "C" int fluidnet_warp_transpose(const float* g, const float* px,
                                       const float* py, const float* pz,
                                       float* out, int B, int G, int F, int Z,
                                       int Y, int X, int window, int nearest,
                                       void* stream) {
  if (F < 1 || F > kMaxF || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{g, px, py, pz, out, B, G, F, Z, Y, X, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nearest)
    err = Z > 1 ? launch<true, true>(a, st) : launch<true, false>(a, st);
  else
    err = Z > 1 ? launch<false, true>(a, st) : launch<false, false>(a, st);
  return static_cast<int>(err);
}
