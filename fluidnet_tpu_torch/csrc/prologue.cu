// K2: the fused forces block and projection prologue; K4: vorticity
// confinement alone.
//
// Replaces the TPU kernel fluidnet_tpu/ops/pallas/forces_kernel.py::_fb_kernel
// in both its forms, and forces_kernel.py::_vc_kernel, with one kernel
// template (EPI, RHO) here:
//   - EPI = true, the projection prologue (epi=True, has_ubc), as launched by
//     _pro_pallas_impl for ops/prologue.projection_prologue: once per
//     ConvNet step, between advection and the ConvNet;
//   - EPI = false, the forces block (epi=False), as launched by
//     _fb_pallas_impl for ops/forces.forces_block: once per jacobi or PCG
//     step. It stops after the force stage: no slab BC, no setWallBcs, no
//     divergence, 3 output channels;
//   - EPI = false, RHO = false, K4 (_vc_pallas_impl for
//     ops/forces.vorticity_confinement, 3-D with a scalar strength): no
//     density is read and the buoyancy/gravity stage is skipped, so what
//     remains is _vc_kernel's chain (border zeroing, the vec3-epsilon
//     guards, the fluid/empty face gating of AddForceField). Compulsory
//     traffic 28 B/cell: u(3) and flags in, u(3) out.
// In order, per cell:
//   [EPI] slab BC on u (rows y < YB: u * inv + bc)
//   -> buoyancy 0.5 * s * (rho(i) + rho(i-1)) on fluid-fluid faces
//   -> gravity on fluid/empty faces
//   -> vorticity confinement: centered u -> curl and |curl| -> normalized
//      grad|curl| x curl * amp -> face-averaged AddForceField
//   [EPI] -> slab BC again -> setWallBcs (incl. TypeStick)
//   [EPI] -> Manta-RHS divergence of the result (4th output channel).
// The chain reaches 4 cells out: confinement is 3 deep and the divergence
// reads the wall-BC'ed velocity at +1 (the forces block needs 3 of the 4).
//
// What bounds it on the H100: data reuse, not arithmetic. Compulsory HBM
// traffic is u(3) + rho + flags in and u(3) [+ div] out, 32 [36] B/cell, but
// each output depends on a 7^3 [9^3] neighbourhood through four [five]
// dependent stencils; done as separate elementwise passes (the plain
// version) that is ~40 full field passes through HBM.
//
// Design: one kernel over a shared-memory tile. A block owns an 8^3 output
// tile and loads a 16^3 input tile (halo 4) into shared memory once; the
// stages then run in order with __syncthreads() between them, each on a
// region one cell smaller than the last (u' on [1,16), centered u on
// [1,15), curl on [2,14), force on [3,13), force-applied u on [4,12) for the
// forces block or, wall-BC'ed, on [4,13) for the prologue, whose outputs are
// on [4,12)). Stages that overwrite a buffer their neighbours still read
// stage their results in registers across a barrier. Shared memory: 7
// floats + 1 flag byte per tile cell = 116 KB, one 512-thread block per SM.
// The TPU kernel's z-blocks of S slices, its lane/sublane padding and its
// roll-based neighbour reads are gone. Cells outside the domain load as
// u = rho = 0 and flags = 0, which is exactly the zero/False fill of
// ops.stencil.shift that the plain version uses. Arithmetic follows the
// JAX composition operation for operation (built with -fmad=false).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kT = 8;                  // output tile edge
constexpr int kH = 4;                  // halo
constexpr int kN = kT + 2 * kH;        // input tile edge
constexpr int kNN = kN * kN;
constexpr int kNC = kN * kN * kN;
constexpr int kThreads = 512;
constexpr float kVec3Eps = 1e-6f;     // vec3 kEpsilon (vec3.cu.h:21)

constexpr unsigned char kFluid = 1, kObstacle = 2, kEmpty = 4, kStick = 128;

struct Smem {
  float u[3][kNC];        // u -> u' (forces) -> wall-BC'ed u
  float a[3][kNC];        // centered u -> curl -> force
  float r[kNC];           // rho -> |curl|
  unsigned char f[kNC];   // flag bits; 0 outside the domain
};

struct Scal {
  float bs[3];   // buoyancy strength per face: -buoy_g * dt / dx
  float gf[3];   // gravity force per face: grav_g * dt / dx
  float amp;     // confinement strength
};

__device__ __forceinline__ int region_cell(int q, int lo, int w, int* lz,
                                           int* ly, int* lx) {
  *lz = lo + q / (w * w);
  *ly = lo + (q / w) % w;
  *lx = lo + q % w;
  return (*lz * kN + *ly) * kN + *lx;
}

template <bool EPI, bool RHO>
__global__ void __launch_bounds__(kThreads)
prologue_kernel(const float* __restrict__ u, const int* __restrict__ flags,
                const float* __restrict__ rho, const float* __restrict__ ubc,
                const float* __restrict__ uinv, float* __restrict__ out,
                int Z, int Y, int X, int YB, Scal sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int tiles_z = (Z + kT - 1) / kT;
  const int b = blockIdx.z / tiles_z;
  const int z0 = (blockIdx.z % tiles_z) * kT - kH;
  const int y0 = blockIdx.y * kT - kH;
  const int x0 = blockIdx.x * kT - kH;
  const size_t n = (size_t)Z * Y * X;
  const float* U = u + (size_t)b * 3 * n;

  auto in_domain = [&](int gz, int gy, int gx) {
    return gz >= 0 && gz < Z && gy >= 0 && gy < Y && gx >= 0 && gx < X;
  };
  auto interior = [&](int gz, int gy, int gx) {
    return gz >= 1 && gz <= Z - 2 && gy >= 1 && gy <= Y - 2 && gx >= 1 &&
           gx <= X - 2;
  };
  // Frozen slab BC (sim.simulate._apply_bc): rows y < YB only.
  auto slab = [&](int c, int gz, int gy, int gx, float v) {
    if (ubc == nullptr || gy >= YB) return v;
    const size_t m = (((size_t)b * 3 + c) * Z + gz) * YB * X +
                     (size_t)gy * X + gx;
    return v * __ldg(uinv + m) + __ldg(ubc + m);
  };

  // Load the input tile, applying the first slab BC to u.
  for (int t = tid; t < kNC; t += kThreads) {
    const int gz = z0 + t / kNN, gy = y0 + (t / kN) % kN, gx = x0 + t % kN;
    if (in_domain(gz, gy, gx)) {
      const size_t g = ((size_t)gz * Y + gy) * X + gx;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        sm.u[c][t] = slab(c, gz, gy, gx, __ldg(U + c * n + g));
      sm.r[t] = RHO ? __ldg(rho + (size_t)b * n + g) : 0.f;
      sm.f[t] = static_cast<unsigned char>(
          __ldg(flags + (size_t)b * n + g) &
          (kFluid | kObstacle | kEmpty | kStick));
    } else {
      sm.u[0][t] = sm.u[1][t] = sm.u[2][t] = 0.f;
      sm.r[t] = 0.f;
      sm.f[t] = 0;
    }
  }
  __syncthreads();

  const int off[3] = {1, kN, kNN};

  // Stage 0: u' = gravity(buoyancy(u)) in place on [1, 16): each cell
  // reads only its own u plus rho/flags of its -axis neighbours. K4 has no
  // such stage.
  if constexpr (RHO) {
    constexpr int lo = 1, w = kN - 1;
    for (int q = tid; q < w * w * w; q += kThreads) {
      int lz, ly, lx;
      const int t = region_cell(q, lo, w, &lz, &ly, &lx);
      const bool in = interior(z0 + lz, y0 + ly, x0 + lx);
      const unsigned char fc = sm.f[t];
      const bool fl = fc & kFluid, em = fc & kEmpty;
      const float rc = sm.r[t];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const unsigned char fm = sm.f[t - off[c]];
        const bool fl_m = fm & kFluid, em_m = fm & kEmpty;
        float v = sm.u[c][t];
        if (fl && fl_m && in) v = v + 0.5f * sc.bs[c] * (rc + sm.r[t - off[c]]);
        if ((fl || em) && in && (fl_m || (fl && em_m))) v = v + sc.gf[c];
        sm.u[c][t] = v;
      }
    }
  }
  __syncthreads();

  // Stage 1: centered velocity on [1, 15), zero off the interior.
  {
    constexpr int lo = 1, w = kN - 2;
    for (int q = tid; q < w * w * w; q += kThreads) {
      int lz, ly, lx;
      const int t = region_cell(q, lo, w, &lz, &ly, &lx);
      const bool in = interior(z0 + lz, y0 + ly, x0 + lx);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        sm.a[c][t] = in ? 0.5f * (sm.u[c][t] + sm.u[c][t + off[c]]) : 0.f;
    }
  }
  __syncthreads();

  // Stage 2: curl and |curl| on [2, 14) (written over the centered field
  // after a barrier: neighbours still read it).
  {
    constexpr int lo = 2, w = kN - 4, cnt = w * w * w;
    constexpr int R = (cnt + kThreads - 1) / kThreads;
    float reg[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = tid + r * kThreads;
      if (q >= cnt) break;
      int lz, ly, lx;
      const int t = region_cell(q, lo, w, &lz, &ly, &lx);
      const float* cx = sm.a[0];
      const float* cy = sm.a[1];
      const float* cz = sm.a[2];
      float wx = 0.5f * ((cz[t + kN] - cz[t - kN]) - (cy[t + kNN] - cy[t - kNN]));
      float wy = 0.5f * ((cx[t + kNN] - cx[t - kNN]) - (cz[t + 1] - cz[t - 1]));
      float wz = 0.5f * ((cy[t + 1] - cy[t - 1]) - (cx[t + kN] - cx[t - kN]));
      if (!interior(z0 + lz, y0 + ly, x0 + lx)) wx = wy = wz = 0.f;
      const float nsq = wx * wx + wy * wy + wz * wz;
      reg[r][0] = wx;
      reg[r][1] = wy;
      reg[r][2] = wz;
      reg[r][3] = nsq > kVec3Eps ? sqrtf(nsq) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = tid + r * kThreads;
      if (q >= cnt) break;
      int lz, ly, lx;
      const int t = region_cell(q, lo, w, &lz, &ly, &lx);
      sm.a[0][t] = reg[r][0];
      sm.a[1][t] = reg[r][1];
      sm.a[2][t] = reg[r][2];
      sm.r[t] = reg[r][3];
    }
  }
  __syncthreads();

  // Stage 3: confinement force on [3, 13), written over the curl.
  {
    constexpr int lo = 3, w = kN - 6, cnt = w * w * w;
    constexpr int R = (cnt + kThreads - 1) / kThreads;
    float reg[R][3];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = tid + r * kThreads;
      if (q >= cnt) break;
      int lz, ly, lx;
      const int t = region_cell(q, lo, w, &lz, &ly, &lx);
      const float* wn = sm.r;
      float gx = 0.5f * (wn[t + 1] - wn[t - 1]);
      float gy = 0.5f * (wn[t + kN] - wn[t - kN]);
      float gz = 0.5f * (wn[t + kNN] - wn[t - kNN]);
      const float gsq = gx * gx + gy * gy + gz * gz;
      const float gn = gsq > kVec3Eps ? sqrtf(gsq) : 0.f;
      const float inv = gn > kVec3Eps ? 1.f / gn : 0.f;
      gx = gx * inv;
      gy = gy * inv;
      gz = gz * inv;
      const float wx = sm.a[0][t], wy = sm.a[1][t], wz = sm.a[2][t];
      const bool in = interior(z0 + lz, y0 + ly, x0 + lx);
      reg[r][0] = in ? (gy * wz - gz * wy) * sc.amp : 0.f;
      reg[r][1] = in ? (gz * wx - gx * wz) * sc.amp : 0.f;
      reg[r][2] = in ? (gx * wy - gy * wx) * sc.amp : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = tid + r * kThreads;
      if (q >= cnt) break;
      int lz, ly, lx;
      const int t = region_cell(q, lo, w, &lz, &ly, &lx);
#pragma unroll
      for (int c = 0; c < 3; ++c) sm.a[c][t] = reg[r][c];
    }
  }
  __syncthreads();

  // Forces block (EPI = false): AddForceField on the output tile [4, 12),
  // written straight out; nothing after it.
  if constexpr (!EPI) {
    constexpr int lo = kH, w = kT;
    for (int q = tid; q < w * w * w; q += kThreads) {
      int lz, ly, lx;
      const int t = region_cell(q, lo, w, &lz, &ly, &lx);
      const int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
      if (!in_domain(gz, gy, gx)) continue;
      const unsigned char fc = sm.f[t];
      const bool fl = fc & kFluid, em = fc & kEmpty;
      const bool cur = (fl || em) && interior(gz, gy, gx);
      float* O = out + (size_t)b * 3 * n + ((size_t)gz * Y + gy) * X + gx;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const unsigned char fm = sm.f[t - off[c]];
        const bool fl_m = fm & kFluid, em_m = fm & kEmpty;
        float x = sm.u[c][t];
        if (cur && (fl_m || (fl && em_m)))
          x = x + 0.5f * (sm.a[c][t - off[c]] + sm.a[c][t]);
        O[c * n] = x;
      }
    }
    return;
  }

  // Stage 4 on [4, 13): AddForceField, the second slab BC, setWallBcs.
  // Written over u' after a barrier (the divergence reads +1 neighbours).
  {
    constexpr int lo = 4, w = kN - 7, cnt = w * w * w;
    constexpr int R = (cnt + kThreads - 1) / kThreads;
    float reg[R][3];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = tid + r * kThreads;
      if (q >= cnt) break;
      int lz, ly, lx;
      const int t = region_cell(q, lo, w, &lz, &ly, &lx);
      const int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
      const unsigned char fc = sm.f[t];
      const bool fl = fc & kFluid, em = fc & kEmpty, ob = fc & kObstacle;
      const bool cur = (fl || em) && interior(gz, gy, gx);
      const bool dom = in_domain(gz, gy, gx);
      bool stick_pm[3];
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const unsigned char fm = sm.f[t - off[c]], fp = sm.f[t + off[c]];
        const bool fl_m = fm & kFluid, em_m = fm & kEmpty;
        float x = sm.u[c][t];
        if (cur && (fl_m || (fl && em_m)))
          x = x + 0.5f * (sm.a[c][t - off[c]] + sm.a[c][t]);
        if (dom) x = slab(c, gz, gy, gx, x);
        // setWallBcs: fluid/obstacle faces into obstacles are zero.
        if ((fl || ob) && ((fm & kObstacle) || (ob && (fm & kFluid)))) x = 0.f;
        v[c] = x;
        stick_pm[c] = (fm & kStick) || (fp & kStick);
      }
      // TypeStick: tangential components of fluid cells next to stick.
      if (fl && stick_pm[1]) v[0] = 0.f;
      if (fl && stick_pm[2]) v[0] = 0.f;
      if (fl && stick_pm[0]) v[1] = 0.f;
      if (fl && stick_pm[2]) v[1] = 0.f;
      if (fl && (stick_pm[0] || stick_pm[1])) v[2] = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) reg[r][c] = v[c];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = tid + r * kThreads;
      if (q >= cnt) break;
      int lz, ly, lx;
      const int t = region_cell(q, lo, w, &lz, &ly, &lx);
#pragma unroll
      for (int c = 0; c < 3; ++c) sm.u[c][t] = reg[r][c];
    }
  }
  __syncthreads();

  // Stage 5: outputs on [4, 12): u'' and its Manta-RHS divergence.
  {
    constexpr int lo = kH, w = kT;
    for (int q = tid; q < w * w * w; q += kThreads) {
      int lz, ly, lx;
      const int t = region_cell(q, lo, w, &lz, &ly, &lx);
      const int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
      if (!in_domain(gz, gy, gx)) continue;
      const size_t g = ((size_t)gz * Y + gy) * X + gx;
      float* O = out + (size_t)b * 4 * n + g;
      const float u0 = sm.u[0][t], u1 = sm.u[1][t], u2 = sm.u[2][t];
      O[0] = u0;
      O[n] = u1;
      O[2 * n] = u2;
      const float div = (u0 - sm.u[0][t + 1]) + (u1 - sm.u[1][t + kN]) +
                        (u2 - sm.u[2][t + kNN]);
      const bool keep = (sm.f[t] & kFluid) && interior(gz, gy, gx);
      O[3 * n] = keep ? div : 0.f;
    }
  }
}

template <bool EPI, bool RHO = true>
int launch(const float* u, const int* flags, const float* rho,
           const float* ubc, const float* uinv, float* out, int B, int Z,
           int Y, int X, int YB, const Scal& sc, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      prologue_kernel<EPI, RHO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((X + kT - 1) / kT, (Y + kT - 1) / kT,
                  ((Z + kT - 1) / kT) * B);
  prologue_kernel<EPI, RHO><<<grid, kThreads, smem, stream>>>(
      u, flags, rho, ubc, uinv, out, Z, Y, X, YB, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u (B,3,Z,Y,X) f32, flags (B,1,Z,Y,X) int32, rho (B,1,Z,Y,X) f32.
// epi != 0, the prologue: ubc/uinv (B,3,Z,YB,X) f32 or null, out
// (B,4,Z,Y,X) f32. epi == 0, the forces block: ubc/uinv null, out
// (B,3,Z,Y,X) f32. scal7 = [bx, by, bz, gx, gy, gz, amp] as
// ops/cuda/forces_kernel.py builds it. Returns cudaGetLastError().
extern "C" int fluidnet_prologue(const float* u, const int* flags,
                                 const float* rho, const float* ubc,
                                 const float* uinv, float* out, int B, int Z,
                                 int Y, int X, int YB, int epi, float bx,
                                 float by, float bz, float gx, float gy,
                                 float gz, float amp, void* stream) {
  const Scal sc{{bx, by, bz}, {gx, gy, gz}, amp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epi)
    return launch<true>(u, flags, rho, ubc, uinv, out, B, Z, Y, X, YB, sc,
                        st);
  return launch<false>(u, flags, rho, nullptr, nullptr, out, B, Z, Y, X, 0,
                       sc, st);
}

// K4: u (B,3,Z,Y,X) f32, flags (B,1,Z,Y,X) int32 -> out (B,3,Z,Y,X) f32,
// vorticity confinement of strength amp. Returns cudaGetLastError().
extern "C" int fluidnet_vorticity(const float* u, const int* flags,
                                  float* out, int B, int Z, int Y, int X,
                                  float amp, void* stream) {
  const Scal sc{{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, amp};
  return launch<false, false>(u, flags, nullptr, nullptr, nullptr, out, B,
                              Z, Y, X, 0, sc,
                              static_cast<cudaStream_t>(stream));
}
