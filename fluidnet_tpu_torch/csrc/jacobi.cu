// K3: the fixed-sweep Jacobi pressure solve.
//
// Replaces the TPU kernel fluidnet_tpu/solvers/pallas_jacobi.py::_kernel, as
// launched by jacobi_pallas for solve_jacobi(p_tol=0): the jacobi-34
// projection, the ConvNet's Jacobi polish and the jacobi training targets.
// From p = 0 (or from a given p0: the rounds of the z-sharded solve,
// parallel/halo.py::slab_jacobi_solve) it runs n sweeps of
//   p <- (p(x-) + p(x+) + p(y-) + p(y+) [+ p(z-) + p(z+)] + div) / (6 | 4)
// where an obstacle neighbour contributes the centre value instead of its
// own, and p is 0 on the 1-cell border (x/y only when Z == 1) and on
// obstacle cells (kernel_jacobiIteration, generic/tfluids.cu:1764-1821).
// Neighbours are summed in the TPU kernel's order (x-, x+, y-, y+, z-, z+),
// then div is added, then a true division (built with -fmad=false): the
// plain PyTorch version (solvers/cuda_jacobi.py) gives the same bits.
//
// What bounds it on the H100: the two bounds nearly meet. Compulsory traffic
// is div and flags in and p out, 12 B/cell (25 MB at 128^3, 7.5 us at
// 3.35 TB/s); 7 flops per interior fluid cell a sweep over 34 sweeps is
// ~480 MFLOP (7.1 us at 67 TFLOP/s). Each sweep depends on the whole
// previous one, so a kernel that keeps p on chip between sweeps needs
// grid-wide synchronisation.
//
// Design: one launch per solve, p kept on chip between sweeps (the TPU
// kernel keeps p, div and the mask in VMEM for all sweeps). The grid's
// x-rows, flattened over (b, z, y), are cut into contiguous ranges, one per
// block. A block builds its range's 1-byte cell codes (zero bit: border or
// obstacle; else its six neighbours' obstacle bits) and p = 0 (or p0) in
// shared memory once. p lives there twice: sweep s reads copy s & 1 and
// writes copy (s + 1) & 1. A thread takes groups of 4 cells of a row (1 when
// X % 4 != 0) at a stride of the block's size: one vector load or store
// serves 4 cells, and no cell needs a division to find its place. x
// neighbours, and y / z neighbours inside the range, come from shared
// memory; a neighbour row outside it from the previous sweep's global copy
// of p. So every sweep also writes the range's first and last `halo` rows
// (a z plane in 3-D, a row in 2-D: the only rows another block reads) to a
// global ping-pong copy, indexed by sweep parity; the last sweep writes the
// whole range to the output. With a range of about one plane (128^3 on 132
// SMs: 125 rows a block) every z neighbour is remote: each sweep reads 8
// B/cell from L2 and writes 4.
// Routes, chosen by the wrapper from the shape alone (jacobi_route):
//   - persistent: one cooperative launch of as many blocks as are
//     co-resident (the occupancy API times the SM count), a grid barrier
//     (cooperative_groups grid.sync) after every sweep but the last. 2-D
//     takes it too: a plane's rows are cut into ranges as a grid's are.
//   - sweep: ranges that do not fit the co-resident blocks' shared memory
//     (256^3) take one launch per sweep of a one-thread-per-cell kernel,
//     two p buffers in ping-pong. Same arithmetic, same bits.
//
// Rules the persistent route depends on:
//   - Stale reads. The global copies are written during the kernel, and
//     L1 is not coherent between SMs: they are read with __ldcg (L2 only)
//     through pointers that are neither const nor __restrict__, so nvcc
//     cannot turn the loads into ld.global.nc. A stale read would show as
//     a wrong bit from sweep 2 on (the card tests run n = 1, 2, 3).
//   - Parity. Sweep s reads copy s & 1 (shared and global, written by
//     sweep s - 1) and writes copy (s + 1) & 1; its barrier comes after
//     both. A thread still reading copy s & 1 in sweep s cannot meet a
//     writer of it: the next write to that copy is in sweep s + 1, after
//     the barrier. So the order is read, compute, write, barrier, with one
//     barrier a sweep. The wrapper makes global copy n & 1 the output, so
//     the last sweep's full write lands there.
//   - Halo rows. A neighbour outside [r0, r1) is at most `halo` rows away
//     (z: Y rows, y: 1), so it lies in the first or last `halo` rows of
//     its owner's range: those are the rows each sweep publishes.
//   - Sweep 0 reads the starting p: every cell of the range from shared
//     copy 0, loaded from p0 (0 without it), border cells included, since
//     a neighbour of the border reads them; a row of another range from
//     p0 itself (0 without it), which nothing writes during the kernel.
//   - Batch edges. Planes k = 0 and k = Z - 1 (3-D) and rows j = 0 and
//     j = Y - 1 (2-D) are border cells, which write 0 and read nothing, so
//     a range that spans two batch items never reads across them; nor does
//     any read leave the grid.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kObstacle = 2;      // the flags' obstacle bit
constexpr int kThreads = 256;     // the per-sweep kernel
constexpr int kResThreads = 1024;  // jacobi_sweeps, the resident kernel
constexpr int kWarps = kResThreads / 32;
constexpr int kZeroBit = 1;  // a cell code's zero bit (border or obstacle)
enum Route { kSweep = 0, kPersistent = 1 };

template <bool IS_3D>
__global__ void __launch_bounds__(kThreads)
jacobi_sweep(const float* __restrict__ p, float* __restrict__ out,
             const float* __restrict__ div, const int* __restrict__ flags,
             int B, int Z, int Y, int X, float denom) {
  const int n = Z * Y * X;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= B * n) return;
  const int c = gid % n;
  const int i = c % X;
  const int j = (c / X) % Y;
  const int k = c / (X * Y);
  bool zero = i == 0 || i == X - 1 || j == 0 || j == Y - 1 ||
              (__ldg(flags + gid) & kObstacle);
  if (IS_3D) zero = zero || k == 0 || k == Z - 1;
  if (zero) {
    out[gid] = 0.f;
    return;
  }
  const float pc = __ldg(p + gid);
  auto nb = [&](int off) {
    return (__ldg(flags + gid + off) & kObstacle) ? pc : __ldg(p + gid + off);
  };
  float tot = nb(-1) + nb(1);
  tot = tot + nb(-X);
  tot = tot + nb(X);
  if (IS_3D) {
    tot = tot + nb(-X * Y);
    tot = tot + nb(X * Y);
  }
  out[gid] = (tot + __ldg(div + gid)) / denom;
}

// V consecutive cells of one row (V = 4 when X % 4 == 0, so that a group
// never leaves its row and its address is 16-byte aligned): loads and
// stores as one vector access.
template <int V>
__device__ __forceinline__ void lds(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x, o[1] = t.y, o[2] = t.z, o[3] = t.w;
  } else {
    o[0] = *p;
  }
}
// From a global copy of p written during the kernel: L2 only (ld.global.cg),
// never the non-coherent read-only path.
template <int V>
__device__ __forceinline__ void ldcg(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    o[0] = t.x, o[1] = t.y, o[2] = t.z, o[3] = t.w;
  } else {
    o[0] = __ldcg(p);
  }
}
template <int V>
__device__ __forceinline__ void ldg(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = t.x, o[1] = t.y, o[2] = t.z, o[3] = t.w;
  } else {
    o[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void sts(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}
template <int V>
__device__ __forceinline__ void stcg(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    __stcg(p, v[0]);
}

// All n sweeps of a solve (the persistent route's resident kernel), one
// block per range of `rpb` rows (the last may be short).
// Dynamic shared memory: p twice (rpb * X floats each; sweep s reads copy
// s & 1 and writes the other), then the range's cell codes (rpb * X
// bytes): 9 bytes a cell. div is read through the read-only path (L1) each
// sweep rather than held here, which would take 13. g0 and g1 are the
// global copies of p. Thread t takes the groups of V cells t,
// t + kResThreads, ... of the range.
template <bool IS_3D, int V>
__global__ void __launch_bounds__(kResThreads, 1)
jacobi_sweeps(const float* __restrict__ div, const int* __restrict__ flags,
              const float* __restrict__ p0, float* g0, float* g1, int Z,
              int Y, int X, int rows, int rpb, int halo, int n_sweeps) {
  extern __shared__ float smem[];
  const int cap = rpb * X;
  uint8_t* sc = reinterpret_cast<uint8_t*>(smem + 2 * cap);
  const int r0 = blockIdx.x * rpb;
  const int nrl = min(rpb, rows - r0);
  const int ncell = nrl * X;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float denom = IS_3D ? 6.f : 4.f;
  const int plane = X * Y;
  const float* dv = div + r0 * X;

  // Cell codes: kZeroBit, or the obstacle bits of the neighbours in sweep
  // order (x-, x+, y-, y+, z-, z+ from bit 1 up). Only a non-zero cell
  // reads its neighbours' flags, so no read leaves the grid.
  for (int rl = warp; rl < nrl; rl += kWarps) {
    const int r = r0 + rl;
    const int j = r % Y;
    bool border_row = j == 0 || j == Y - 1;
    if (IS_3D) {
      const int k = (r / Y) % Z;
      border_row = border_row || k == 0 || k == Z - 1;
    }
    for (int i = lane; i < X; i += 32) {
      const int g = r * X + i;
      auto ob = [&](int off) {
        return (__ldg(flags + g + off) & kObstacle) ? 1 : 0;
      };
      int code = kZeroBit;
      if (!(border_row || i == 0 || i == X - 1 || ob(0))) {
        code = ob(-1) << 1 | ob(1) << 2 | ob(-X) << 3 | ob(X) << 4;
        if (IS_3D) code |= ob(-plane) << 5 | ob(plane) << 6;
      }
      sc[rl * X + i] = static_cast<uint8_t>(code);
      smem[rl * X + i] = p0 ? __ldg(p0 + g) : 0.f;
    }
  }
  __syncthreads();

  const int lo = halo * X, hi = (nrl - halo) * X;
  for (int s = 0; s < n_sweeps; ++s) {
    // Shared pointers by arithmetic on smem, so that nvcc keeps them in
    // the shared window (LDS, not generic loads).
    const float* cur = smem + (s & 1) * cap;
    float* nxt = smem + ((s + 1) & 1) * cap;
    float* src = ((s & 1) ? g1 : g0) + r0 * X;  // written by sweep s - 1
    float* dst = ((s & 1) ? g0 : g1) + r0 * X;
    const bool last = s + 1 == n_sweeps;
    // The V cells `d` away from the group at c (another row): shared
    // memory inside the range, else the previous sweep's global copy (p0,
    // or 0, in sweep 0). Read only for a group with a non-zero cell, whose
    // neighbour rows lie in the grid.
    auto row_nb = [&](int c, int d, float (&o)[V]) {
      if (static_cast<unsigned>(c + d) < static_cast<unsigned>(ncell)) {
        lds<V>(cur + c + d, o);
      } else if (s > 0) {
        ldcg<V>(src + c + d, o);
      } else if (p0) {
        ldg<V>(p0 + r0 * X + c + d, o);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] = 0.f;
      }
    };
#pragma unroll 2
    for (int c = V * threadIdx.x; c < ncell; c += V * kResThreads) {
      int code[V];
      if constexpr (V == 4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(sc + c);
        for (int k = 0; k < V; ++k) code[k] = (w >> (8 * k)) & 0xff;
      } else {
        code[0] = sc[c];
      }
      bool any = false;
#pragma unroll
      for (int k = 0; k < V; ++k) any = any || !(code[k] & kZeroBit);
      float val[V];
#pragma unroll
      for (int k = 0; k < V; ++k) val[k] = 0.f;
      if (any) {
        float pc[V], ym[V], yp[V], zm[V], zp[V], d[V];
        lds<V>(cur + c, pc);
        // x neighbours outside the group: a row's first and last cells
        // are border cells, so these reads stay in the range.
        const float xl = c > 0 ? cur[c - 1] : 0.f;
        const float xr = c + V < ncell ? cur[c + V] : 0.f;
        row_nb(c, -X, ym);
        row_nb(c, X, yp);
        if (IS_3D) {
          row_nb(c, -plane, zm);
          row_nb(c, plane, zp);
        }
        ldg<V>(dv + c, d);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (code[k] & kZeroBit) continue;
          const float ctr = pc[k];
          const float xm = k > 0 ? pc[k - 1] : xl;
          const float xp = k < V - 1 ? pc[k + 1] : xr;
          float tot = ((code[k] & 2) ? ctr : xm) + ((code[k] & 4) ? ctr : xp);
          tot = tot + ((code[k] & 8) ? ctr : ym[k]);
          tot = tot + ((code[k] & 16) ? ctr : yp[k]);
          if (IS_3D) {
            tot = tot + ((code[k] & 32) ? ctr : zm[k]);
            tot = tot + ((code[k] & 64) ? ctr : zp[k]);
          }
          // A zero numerator gives 0 of its sign without the division,
          // whose IEEE form takes its slow path on a 0: a region of zero
          // divergence (an empty domain's far field) costs no more.
          const float num = tot + d[k];
          val[k] = num == 0.f ? num : num / denom;
        }
      }
      sts<V>(nxt + c, val);
      if (last || c < lo || c >= hi) stcg<V>(dst + c, val);
    }
    if (!last) cg::this_grid().sync();
  }
}

template <bool IS_3D, int V>
cudaError_t launch_sweeps(const float* div, const int* flags, const float* p0,
                          float* g0, float* g1, int Z, int Y, int X, int rows,
                          int rpb, int halo, int n_sweeps, int smem,
                          cudaStream_t st) {
  auto kern = jacobi_sweeps<IS_3D, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + rpb - 1) / rpb);
  cfg.blockDim = dim3(kResThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, div, flags, p0, g0, g1, Z, Y, X,
                            rows, rpb, halo, n_sweeps);
}

template <bool IS_3D>
cudaError_t launch_sweeps(const float* div, const int* flags, const float* p0,
                          float* g0, float* g1, int Z, int Y, int X, int rows,
                          int rpb, int halo, int n_sweeps, int smem,
                          cudaStream_t st) {
  if (X % 4 == 0)
    return launch_sweeps<IS_3D, 4>(div, flags, p0, g0, g1, Z, Y, X, rows,
                                   rpb, halo, n_sweeps, smem, st);
  return launch_sweeps<IS_3D, 1>(div, flags, p0, g0, g1, Z, Y, X, rows, rpb,
                                 halo, n_sweeps, smem, st);
}

}  // namespace

// The current device's limits for the persistent route: the blocks of
// jacobi_sweeps that can be co-resident when each takes the most dynamic
// shared memory a block may (the occupancy API times the SM count), and
// that most. Returns cudaGetLastError().
extern "C" int fluidnet_jacobi_limits(int* resident, int* smem_limit) {
  int dev = 0, n_sm = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(jacobi_sweeps<true, 4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, jacobi_sweeps<true, 4>, kResThreads, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = per_sm * n_sm;
  *smem_limit = optin;
  return static_cast<int>(cudaGetLastError());
}

// div (B,1,Z,Y,X) f32, flags (B,1,Z,Y,X) int32; p0 (B,1,Z,Y,X) f32 or
// null; out (B,1,Z,Y,X) f32 gets p after n_sweeps sweeps from p0 (null: p
// = 0). scratch: a second (B,1,Z,Y,X) f32 buffer. route, rpb, halo, smem:
// the partition solvers/cuda_jacobi.py::jacobi_route chose. Returns cudaGetLastError()
// after the last launch (or the first that failed).
extern "C" int fluidnet_jacobi(const float* div, const int* flags,
                               const float* p0, float* out, float* scratch,
                               int B, int Z, int Y, int X, int n_sweeps,
                               int route, int rpb, int halo, int smem,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_sweeps <= 0) return static_cast<int>(cudaGetLastError());
  const bool is_3d = Z > 1;
  const int total = B * Z * Y * X;
  // Copy n & 1 is the output: the last sweep writes copy n & 1.
  float* bufs[2];
  bufs[n_sweeps & 1] = out;
  bufs[(n_sweeps + 1) & 1] = scratch;
  cudaError_t err;
  if (route == kSweep) {
    err = p0 ? cudaMemcpyAsync(bufs[0], p0, sizeof(float) * total,
                               cudaMemcpyDeviceToDevice, st)
             : cudaMemsetAsync(bufs[0], 0, sizeof(float) * total, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((total + kThreads - 1) / kThreads);
    const float denom = is_3d ? 6.f : 4.f;
    for (int s = 0; s < n_sweeps; ++s) {
      const float* src = bufs[s & 1];
      float* dst = bufs[(s + 1) & 1];
      if (is_3d)
        jacobi_sweep<true><<<grid, kThreads, 0, st>>>(src, dst, div, flags,
                                                      B, Z, Y, X, denom);
      else
        jacobi_sweep<false><<<grid, kThreads, 0, st>>>(src, dst, div, flags,
                                                       B, Z, Y, X, denom);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kPersistent) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * Z * Y;
  if (is_3d)
    err = launch_sweeps<true>(div, flags, p0, bufs[0], bufs[1], Z, Y, X,
                              rows, rpb, halo, n_sweeps, smem, st);
  else
    err = launch_sweeps<false>(div, flags, p0, bufs[0], bufs[1], Z, Y, X,
                               rows, rpb, halo, n_sweeps, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
