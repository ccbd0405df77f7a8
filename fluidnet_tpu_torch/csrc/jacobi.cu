// K3: the fixed-sweep Jacobi pressure solve.
//
// Replaces the TPU kernel fluidnet_tpu/solvers/pallas_jacobi.py::_kernel, as
// launched by jacobi_pallas for solve_jacobi(p_tol=0): the jacobi-34
// projection and the ConvNet's Jacobi polish. From p = 0 it runs n sweeps of
//   p <- (p(x-) + p(x+) + p(y-) + p(y+) [+ p(z-) + p(z+)] + div) / (6 | 4)
// where an obstacle neighbour contributes the centre value instead of its
// own, and p is 0 on the 1-cell border (x/y only when Z == 1) and on
// obstacle cells (kernel_jacobiIteration, generic/tfluids.cu:1764-1821).
//
// What bounds it on the H100: the two bounds nearly meet. Compulsory traffic
// is div and flags in and p out, 12 B/cell (25 MB at 128^3, 7.5 us at
// 3.35 TB/s); 7 flops per interior fluid cell a sweep (5 adds, the div add,
// a division) over 34 sweeps is ~480 MFLOP (7.1 us at 67 TFLOP/s). Each
// sweep depends on the whole previous one, so a kernel that keeps p
// between sweeps on chip needs grid-wide synchronisation or a tile with a
// halo as deep as the sweeps it fuses.
//
// Design (simple and right first): two p buffers in ping-pong and one
// launch per sweep, all from one C call. One thread per cell, x fastest. At
// 128^3 the working set (two p buffers, div, flags: 32 MB) stays in the
// 50 MB L2, so the repeated sweeps read L2, not HBM. A border or obstacle
// cell writes 0 without reading a neighbour, so no read leaves the grid (the
// TPU kernel's circular rolls relied on the same forced zeros). Neighbours
// are summed in the TPU kernel's order (x-, x+, y-, y+, z-, z+), then div,
// then a true division (built with -fmad=false): the plain PyTorch version
// (solvers/cuda_jacobi.py) gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kObstacle = 2;
constexpr int kThreads = 256;

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

}  // namespace

// div (B,1,Z,Y,X) f32, flags (B,1,Z,Y,X) int32; p0 and p1 (B,1,Z,Y,X) f32
// scratch, p0 zero on entry. Runs n_sweeps sweeps alternating p0 -> p1 ->
// p0 ...; the result is in p1 if n_sweeps is odd, else in p0. Returns
// cudaGetLastError() after the last launch (or the first that failed).
extern "C" int fluidnet_jacobi(const float* div, const int* flags, float* p0,
                               float* p1, int B, int Z, int Y, int X,
                               int n_sweeps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total = B * Z * Y * X;
  const dim3 grid((total + kThreads - 1) / kThreads);
  const bool is_3d = Z > 1;
  const float denom = is_3d ? 6.f : 4.f;
  float* bufs[2] = {p0, p1};
  for (int s = 0; s < n_sweeps; ++s) {
    const float* src = bufs[s & 1];
    float* dst = bufs[(s + 1) & 1];
    if (is_3d)
      jacobi_sweep<true><<<grid, kThreads, 0, st>>>(src, dst, div, flags, B,
                                                    Z, Y, X, denom);
    else
      jacobi_sweep<false><<<grid, kThreads, 0, st>>>(src, dst, div, flags, B,
                                                     Z, Y, X, denom);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
