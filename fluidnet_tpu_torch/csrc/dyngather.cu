// K7: take_along_axis on a 2-D block, the counterpart of the Mosaic probe.
//
// Replaces the TPU kernels scripts/test_dyngather.py::k_lane and ::k_sublane
// (one pallas_call on a (128, 128) float32 block held in VMEM):
//   axis 1 (lane):    out[r, c] = src[r, idx[r, c]]
//   axis 0 (sublane): out[r, c] = src[idx[r, c], c]
// for any (R, C) float32 src and int32 or int64 idx of the same shape, with
// every index in [0, C) (axis 1) or [0, R) (axis 0). The kernel reads no
// host value and makes no check of the indices: that is the caller's
// contract, as it is the probe's.
//
// What bounds it on the H100: memory traffic, src and idx read once and out
// written once, 12 B an element with int32 indices (196,608 B at 128x128,
// 0.059 us at 3.35 TB/s); there is no arithmetic. At the probe's size the
// launch itself (a few microseconds) dominates by far.
//
// Design (simple and right first): one thread per output element. The lane
// form runs one block per row and stages that row of src in shared memory
// (128 floats at the probe's width, the counterpart of the VMEM block), so
// each gather reads shared memory; rows wider than the shared-memory budget
// gather straight from global memory. The sublane form gathers down a
// column straight from global memory (through L1/L2): one warp's 32
// neighbouring outputs read 32 scattered rows, which the caches absorb at
// these sizes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSharedCols = 12288;   // 48 KB of floats: no opt-in needed

template <typename I, bool SHARED>
__global__ void __launch_bounds__(kThreads)
gather_lane(const float* __restrict__ src, const I* __restrict__ idx,
            float* __restrict__ out, int C) {
  extern __shared__ float row[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * C;
  if (SHARED) {
    for (int c = threadIdx.x; c < C; c += kThreads) row[c] = src[base + c];
    __syncthreads();
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int64_t j = static_cast<int64_t>(idx[base + c]);
    out[base + c] = SHARED ? row[j] : src[base + j];
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_sublane(const float* __restrict__ src, const I* __restrict__ idx,
               float* __restrict__ out, int R, int C) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (g >= static_cast<int64_t>(R) * C) return;
  const int64_t col = g % C;
  out[g] = src[static_cast<int64_t>(idx[g]) * C + col];
}

template <typename I>
int launch(const float* src, const I* idx, float* out, int R, int C,
           int axis, cudaStream_t st) {
  if (axis == 1) {
    if (C <= kMaxSharedCols)
      gather_lane<I, true><<<R, kThreads, C * sizeof(float), st>>>(
          src, idx, out, C);
    else
      gather_lane<I, false><<<R, kThreads, 0, st>>>(src, idx, out, C);
  } else {
    const int64_t n = static_cast<int64_t>(R) * C;
    const unsigned grid = static_cast<unsigned>((n + kThreads - 1) /
                                                kThreads);
    gather_sublane<I><<<grid, kThreads, 0, st>>>(src, idx, out, R, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src (R, C) f32, idx (R, C) int32 (idx64 == 0) or int64, out (R, C) f32,
// all contiguous on one device; axis 0 or 1. Returns cudaGetLastError().
extern "C" int fluidnet_dyngather(const float* src, const void* idx,
                                  float* out, int R, int C, int axis,
                                  int idx64, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch(src, static_cast<const int64_t*>(idx), out, R, C, axis,
                  st);
  return launch(src, static_cast<const int32_t*>(idx), out, R, C, axis, st);
}
