// K2: the fused forces block and projection prologue; K4: vorticity
// confinement alone.
//
// Replaces the TPU kernel fluidnet_tpu/ops/pallas/forces_kernel.py::_fb_kernel
// in both its forms, and forces_kernel.py::_vc_kernel, with one kernel
// template (EPI, RHO, TY) here:
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
//     guards, the fluid/empty face gating of AddForceField).
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
// What bounds it on the H100: bytes. Compulsory HBM traffic is u(3) + rho +
// flags in and u(3) [+ div] out: 32 B/cell for the forces block, 36 B/cell
// (+ the slab masks' rows) for the prologue, 28 B/cell for K4 (no rho).
// Each output depends on a 7^3 [9^3] neighbourhood through four [five]
// dependent stencils; done as separate elementwise passes (the plain
// version) that is ~40 full field passes through HBM.
//
// Design: a z-march over an xy tile, as the TPU kernel marched its z-blocks
// with whole planes in VMEM. A block owns a 32 x TY output tile (TY = 8 or
// 16) and a range of Zc output planes (ops/cuda/forces_kernel.py's
// prologue_tiling picks them from the shape and the SM count), and has
// one thread per column of the tile grown by the halo of 4: 40 x (TY + 8)
// threads. It walks the planes from the range's start - 4, each input
// plane read from HBM once: at step z a thread asks cp.async for its own
// column's u, rho, flags (and slab masks) of plane z + 3 into a staging
// ring of four planes in shared memory, so three planes are in flight
// while one computes. Step z runs the stages on planes z (u'), z - 1
// (centered u), z - 2 (curl, |curl|), z - 3 (force), z - 4 (AddForceField
// [, slab, setWallBcs]) and, in the prologue, z - 5 (the outputs and the
// divergence), then waits for plane z + 1 and meets the block's one barrier
// a step. A stage reads its xy-neighbours from what the stage before it
// published in the previous step, and its own column's z-neighbours from
// registers (u' of five planes, centered u, curl, |curl|, force and
// wall-BC'ed u of two or three). Shared memory holds the staging ring, the
// slab masks of eight planes (prologue, first tile row), what
// xy-neighbours read, each plane of it twice by plane parity (written in
// step z, read in step z + 1), and eight planes of flags as 1-byte codes:
// 168 B a plane cell (+ 61,440 B of slab masks in the prologue): at
// TY = 16 222,720 B for the prologue, 161,472 B for the forces block and
// K4. Registers (64-83 a thread) leave one block an SM, so the table
// sizes the ranges for one wave. Stage k runs on the
// columns the stages after it read (the tile grown by 4 - k, as the TPU
// kernel's shrinking regions). So against the 8^3-tile design this
// replaces, whose blocks reloaded a 16^3 tile for 8^3 outputs (8x) and
// evaluated the six stages 19.7 times an output cell on shrinking cubes
// (3.3x), with six barriers between them, an input cell is read
// (Zc + 8) / Zc x 40 (TY + 8) / (32 TY) times (2.3x at 128^3 with
// TY = 16, Zc = 32; most of the halo from L2), a stage is evaluated about
// as often, and a step has one barrier.
// Cells outside the domain load as u = rho = 0 and flags = 0, which is
// exactly the zero/False fill of ops.stencil.shift that the plain version
// uses; every stage on them gives 0, as the plain composition's zero fill
// of its intermediates. Arithmetic follows the JAX composition operation for
// operation (built with -fmad=false): the same float32 operations in the
// same order as the plain version, so the results are equal to the bit.

#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"

namespace {

constexpr int kTX = 32;                // output tile width (x)
constexpr int kH = 4;                  // halo
constexpr int kW = kTX + 2 * kH;       // columns a row of the block
constexpr float kVec3Eps = 1e-6f;     // vec3 kEpsilon (vec3.cu.h:21)

constexpr unsigned char kFluid = 1, kObstacle = 2, kEmpty = 4, kStick = 128;

template <int TY>
struct Tile {
  static constexpr int kRows = TY + 2 * kH;
  static constexpr int kP = kW * kRows;   // plane cells = threads
};

constexpr int kStage = 4;   // input planes staged: z and three in flight
constexpr int kSlabRows = 2 * kH;   // block rows that may hold y < YB <= 4

// The inputs of planes z .. z + 3, staged by cp.async [z & 3]; the slab
// masks of planes z - 4 .. z + 3 [z & 7] (rows y < YB of the first tile
// row, EPI only). Each intermediate that xy-neighbours read, by plane
// parity: step z writes the buffers of its planes, step z + 1 reads them
// after the step's one barrier. Flag bytes of planes z - 4 .. z [z & 7].
template <int TY, bool EPI>
struct Smem {
  static constexpr int P = Tile<TY>::kP;
  static constexpr int kSlab = EPI ? kW * kSlabRows : 1;
  float su[kStage][3][P];  // u
  float sr[kStage][P];     // rho
  int sf[kStage][P];       // flags
  float up[2][2][P];       // u'_x, u'_y
  float cc[2][3][P];       // centered u
  float wn[2][P];          // |curl|
  float fo[2][2][P];       // force_x, force_y
  float wu[2][2][P];       // wall-BC'ed u_x, u_y (EPI)
  float slab[8][6][kSlab]; // slab inv(3), bc(3)
  unsigned char fl[8][P];  // flag bits; 0 outside the domain
};
// ops/cuda/forces_kernel.py::smem_bytes mirrors these sizes.
static_assert(sizeof(Smem<8, true>) == 168 * kW * 16 + 8 * 6 * 4 * kW * 8,
              "Smem<8, true> layout");
static_assert(sizeof(Smem<16, false>) == 168 * kW * 24 + 8 * 6 * 4,
              "Smem<16, false> layout");

// Waits until at most kStage - 2 groups (planes z + 2, z + 3) are pending.
__device__ __forceinline__ void cp_async_wait_next() {
  cp_async_wait<kStage - 2>();
}

struct Scal {
  float bs[3];   // buoyancy strength per face: -buoy_g * dt / dx
  float gf[3];   // gravity force per face: grav_g * dt / dx
  float amp;     // confinement strength
};

template <bool EPI, bool RHO, int TY>
__global__ void __launch_bounds__(Tile<TY>::kP)
prologue_kernel(const float* __restrict__ u, const int* __restrict__ flags,
                const float* __restrict__ rho, const float* __restrict__ ubc,
                const float* __restrict__ uinv, float* __restrict__ out,
                int Z, int Y, int X, int YB, int Zc, Scal sc) {
  constexpr int kRows = Tile<TY>::kRows;
  constexpr int kLag = EPI ? 5 : 4;    // step z writes plane z - kLag
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<TY, EPI>& sm = *reinterpret_cast<Smem<TY, EPI>*>(smem_raw);
  const int t = threadIdx.x;
  const int lx = t % kW, ly = t / kW;
  const int ranges = (Z + Zc - 1) / Zc;
  const int b = blockIdx.z / ranges;
  const int zs = (blockIdx.z % ranges) * Zc;
  const int ze = min(zs + Zc, Z);
  const int gx = blockIdx.x * kTX - kH + lx;
  const int gy = blockIdx.y * TY - kH + ly;
  const size_t n = (size_t)Z * Y * X;
  const float* U = u + (size_t)b * 3 * n;
  const int* F = flags + (size_t)b * n;
  const bool col = gy >= 0 && gy < Y && gx >= 0 && gx < X;
  const bool inxy = gy >= 1 && gy <= Y - 2 && gx >= 1 && gx <= X - 2;
  const bool slab_row = ubc != nullptr && col && gy < YB;
  auto interior = [&](int gz) { return inxy && gz >= 1 && gz <= Z - 2; };
  auto slab_at = [&](int c, int gz) {   // slab mask index, rows y < YB
    return (((size_t)b * 3 + c) * Z + gz) * YB * X + (size_t)gy * X + gx;
  };
  auto rect = [&](int k, int hi) {   // columns [k, kW - hi) x [k, rows - hi)
    return lx >= k && lx < kW - hi && ly >= k && ly < kRows - hi;
  };
  const bool r0 = lx >= 1 && ly >= 1;      // u'
  const bool r1 = rect(1, 1);              // centered u
  const bool r2 = rect(2, 2);              // curl, |curl|
  const bool r3 = rect(3, 3);              // force
  const bool r4 = rect(4, 3);              // wall-BC'ed u (EPI)
  const bool ro = rect(4, 4) && col;       // outputs

  // Requests plane gz of the column into the staging ring: u, rho, flags
  // and (rows y < YB) the slab masks; zeros outside the domain.
  auto request = [&](int gz) {
    const bool in = col && gz >= 0 && gz < Z;
    const size_t g = in ? ((size_t)gz * Y + gy) * X + gx : 0;
    const int q = gz & (kStage - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) cp_async4(&sm.su[q][c][t], U + c * n + g, in);
    if (RHO) cp_async4(&sm.sr[q][t], rho + (size_t)b * n + g, in);
    cp_async4(&sm.sf[q][t], F + g, in);
    if (EPI && slab_row) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const size_t m = in ? slab_at(c, gz) : 0;
        cp_async4(&sm.slab[gz & 7][c][t], uinv + m, in);
        cp_async4(&sm.slab[gz & 7][3 + c][t], ubc + m, in);
      }
    }
  };
  auto code = [](int f) {
    return static_cast<unsigned char>(f &
                                      (kFluid | kObstacle | kEmpty | kStick));
  };

  // A column's own history, newest first.
  float up[5][3] = {};     // u' at z .. z-4
  float cxy[3][2] = {};    // centered u_x, u_y at z-1, z-2, z-3
  float wv[2][3] = {};     // curl at z-2, z-3
  float wm[3] = {};        // |curl| at z-2, z-3, z-4
  float fo[3] = {}, fo_m[3] = {};   // force at z-3, z-4
  float fz_mm = 0.f;       // force_z at z-5
  float wu[3] = {}, wu_m[3] = {};   // wall-BC'ed u at z-4, z-5
  unsigned char f0 = 0, f1 = 0, f2 = 0, f3 = 0, f4 = 0, f5 = 0;  // z .. z-5
  float r_c = 0.f, r_m = 0.f;       // rho at z, z-1

  const int z_load = ze + kLag - 1;  // planes [zs - 4, z_load) are read
  for (int k = 0; k < kStage - 1; ++k) {
    if (zs - kH + k < z_load) request(zs - kH + k);
    cp_async_commit();
  }
  cp_async_wait_next();
  __syncthreads();
  for (int z = zs - kH; z < ze + kLag; ++z) {
    if (z + kStage - 1 < z_load) request(z + kStage - 1);
    cp_async_commit();
    // Plane z from the staging ring: the first slab BC on u.
    const int zq = z & (kStage - 1);
    float uin[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uin[c] = sm.su[zq][c][t];
      if (EPI && slab_row)
        uin[c] = uin[c] * sm.slab[z & 7][c][t] + sm.slab[z & 7][3 + c][t];
    }
    f5 = f4; f4 = f3; f3 = f2; f2 = f1; f1 = f0; f0 = code(sm.sf[zq][t]);
    sm.fl[z & 7][t] = f0;
    r_m = r_c;
    r_c = RHO ? sm.sr[zq][t] : 0.f;

    // Stage 0 on plane z: u' = gravity(buoyancy(u)); each cell reads its
    // own u plus rho/flags of its -axis neighbours. K4 has no such stage.
#pragma unroll
    for (int k = 4; k > 0; --k)
#pragma unroll
      for (int c = 0; c < 3; ++c) up[k][c] = up[k - 1][c];
#pragma unroll
    for (int c = 0; c < 3; ++c) up[0][c] = uin[c];
    if (RHO && r0) {
      const int* fz = sm.sf[zq];
      const float* rz = sm.sr[zq];
      const bool in = interior(z);
      const bool fl = f0 & kFluid, em = f0 & kEmpty;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const unsigned char fm =
            c == 0 ? code(fz[t - 1]) : c == 1 ? code(fz[t - kW]) : f1;
        const float rm = c == 0 ? rz[t - 1] : c == 1 ? rz[t - kW] : r_m;
        const bool fl_m = fm & kFluid, em_m = fm & kEmpty;
        float v = up[0][c];
        if (fl && fl_m && in) v = v + 0.5f * sc.bs[c] * (r_c + rm);
        if ((fl || em) && in && (fl_m || (fl && em_m))) v = v + sc.gf[c];
        up[0][c] = v;
      }
    }
    sm.up[z & 1][0][t] = up[0][0];
    sm.up[z & 1][1][t] = up[0][1];

    // Stage 1 on plane z - 1: centered velocity, zero off the interior.
#pragma unroll
    for (int k = 2; k > 0; --k) {
      cxy[k][0] = cxy[k - 1][0];
      cxy[k][1] = cxy[k - 1][1];
    }
    if (r1) {
      const int q = (z - 1) & 1;
      const bool in = interior(z - 1);
      const float c0 = in ? 0.5f * (up[1][0] + sm.up[q][0][t + 1]) : 0.f;
      const float c1 = in ? 0.5f * (up[1][1] + sm.up[q][1][t + kW]) : 0.f;
      const float c2 = in ? 0.5f * (up[1][2] + up[0][2]) : 0.f;
      cxy[0][0] = c0;
      cxy[0][1] = c1;
      sm.cc[q][0][t] = c0;
      sm.cc[q][1][t] = c1;
      sm.cc[q][2][t] = c2;
    }

    // Stage 2 on plane z - 2: curl and |curl|.
#pragma unroll
    for (int c = 0; c < 3; ++c) wv[1][c] = wv[0][c];
    wm[2] = wm[1];
    wm[1] = wm[0];
    if (r2) {
      const int q = (z - 2) & 1;
      const float* cx = sm.cc[q][0];
      const float* cy = sm.cc[q][1];
      const float* cz = sm.cc[q][2];
      float wx = 0.5f * ((cz[t + kW] - cz[t - kW]) - (cxy[0][1] - cxy[2][1]));
      float wy = 0.5f * ((cxy[0][0] - cxy[2][0]) - (cz[t + 1] - cz[t - 1]));
      float wz = 0.5f * ((cy[t + 1] - cy[t - 1]) - (cx[t + kW] - cx[t - kW]));
      if (!interior(z - 2)) wx = wy = wz = 0.f;
      const float nsq = wx * wx + wy * wy + wz * wz;
      wv[0][0] = wx;
      wv[0][1] = wy;
      wv[0][2] = wz;
      wm[0] = nsq > kVec3Eps ? sqrtf(nsq) : 0.f;
      sm.wn[q][t] = wm[0];
    }

    // Stage 3 on plane z - 3: the confinement force.
    fz_mm = fo_m[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) fo_m[c] = fo[c];
    if (r3) {
      const int q = (z - 3) & 1;
      const float* wn = sm.wn[q];
      float gx_ = 0.5f * (wn[t + 1] - wn[t - 1]);
      float gy_ = 0.5f * (wn[t + kW] - wn[t - kW]);
      float gz_ = 0.5f * (wm[0] - wm[2]);
      const float gsq = gx_ * gx_ + gy_ * gy_ + gz_ * gz_;
      const float gn = gsq > kVec3Eps ? sqrtf(gsq) : 0.f;
      const float inv = gn > kVec3Eps ? 1.f / gn : 0.f;
      gx_ = gx_ * inv;
      gy_ = gy_ * inv;
      gz_ = gz_ * inv;
      const float wx = wv[1][0], wy = wv[1][1], wz = wv[1][2];
      const bool in = interior(z - 3);
      fo[0] = in ? (gy_ * wz - gz_ * wy) * sc.amp : 0.f;
      fo[1] = in ? (gz_ * wx - gx_ * wz) * sc.amp : 0.f;
      fo[2] = in ? (gx_ * wy - gy_ * wx) * sc.amp : 0.f;
      sm.fo[q][0][t] = fo[0];
      sm.fo[q][1][t] = fo[1];
    }

    // Stage 4 on plane z - 4: AddForceField; for the prologue then the
    // second slab BC and setWallBcs. The forces block writes it out.
#pragma unroll
    for (int c = 0; c < 3; ++c) wu_m[c] = wu[c];
    if (EPI ? r4 : ro) {
      const int gz = z - 4;
      const unsigned char* fz = sm.fl[gz & 7];
      const float* fox = sm.fo[gz & 1][0];
      const float* foy = sm.fo[gz & 1][1];
      const bool fl = f4 & kFluid, em = f4 & kEmpty, ob = f4 & kObstacle;
      const bool cur = (fl || em) && interior(gz);
      const bool dom = col && gz >= 0 && gz < Z;
      bool stick_pm[3];
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const unsigned char fm = c == 0 ? fz[t - 1] : c == 1 ? fz[t - kW] : f5;
        const unsigned char fp = c == 0 ? fz[t + 1] : c == 1 ? fz[t + kW] : f3;
        const float fnb = c == 0 ? fox[t - 1] : c == 1 ? foy[t - kW] : fz_mm;
        const bool fl_m = fm & kFluid, em_m = fm & kEmpty;
        float x = up[4][c];
        if (cur && (fl_m || (fl && em_m))) x = x + 0.5f * (fnb + fo_m[c]);
        if (EPI) {
          if (dom && slab_row)
            x = x * sm.slab[gz & 7][c][t] + sm.slab[gz & 7][3 + c][t];
          // setWallBcs: fluid/obstacle faces into obstacles are zero.
          if ((fl || ob) && ((fm & kObstacle) || (ob && (fm & kFluid))))
            x = 0.f;
        }
        v[c] = x;
        stick_pm[c] = (fm & kStick) || (fp & kStick);
      }
      if (EPI) {
        // TypeStick: tangential components of fluid cells next to stick.
        if (fl && stick_pm[1]) v[0] = 0.f;
        if (fl && stick_pm[2]) v[0] = 0.f;
        if (fl && stick_pm[0]) v[1] = 0.f;
        if (fl && stick_pm[2]) v[1] = 0.f;
        if (fl && (stick_pm[0] || stick_pm[1])) v[2] = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) wu[c] = v[c];
        sm.wu[gz & 1][0][t] = v[0];
        sm.wu[gz & 1][1][t] = v[1];
      } else if (gz >= zs && gz < ze) {
        float* O = out + (size_t)b * 3 * n + ((size_t)gz * Y + gy) * X + gx;
#pragma unroll
        for (int c = 0; c < 3; ++c) O[c * n] = v[c];
      }
    }

    // Stage 5 on plane z - 5 (prologue): u'' and its Manta-RHS divergence.
    if (EPI && ro) {
      const int gz = z - 5;
      if (gz >= zs && gz < ze) {
        const int q = gz & 1;
        float* O = out + (size_t)b * 4 * n + ((size_t)gz * Y + gy) * X + gx;
        const float u0 = wu_m[0], u1 = wu_m[1], u2 = wu_m[2];
        O[0] = u0;
        O[n] = u1;
        O[2 * n] = u2;
        const float div = (u0 - sm.wu[q][0][t + 1]) +
                          (u1 - sm.wu[q][1][t + kW]) + (u2 - wu[2]);
        const bool keep = (f5 & kFluid) && interior(gz);
        O[3 * n] = keep ? div : 0.f;
      }
    }

    cp_async_wait_next();
    __syncthreads();
  }
}

template <bool EPI, bool RHO, int TY>
int launch_tiled(const float* u, const int* flags, const float* rho,
                 const float* ubc, const float* uinv, float* out, int B,
                 int Z, int Y, int X, int YB, int Zc, const Scal& sc,
                 cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<TY, EPI>));
  cudaError_t err = cudaFuncSetAttribute(
      prologue_kernel<EPI, RHO, TY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((X + kTX - 1) / kTX, (Y + TY - 1) / TY,
                  ((Z + Zc - 1) / Zc) * B);
  prologue_kernel<EPI, RHO, TY><<<grid, Tile<TY>::kP, smem, stream>>>(
      u, flags, rho, ubc, uinv, out, Z, Y, X, YB, Zc, sc);
  return static_cast<int>(cudaGetLastError());
}

// The tile heights ops/cuda/forces_kernel.py::TILE_YS names.
template <bool EPI, bool RHO = true>
int launch(const float* u, const int* flags, const float* rho,
           const float* ubc, const float* uinv, float* out, int B, int Z,
           int Y, int X, int YB, int ty, int Zc, const Scal& sc,
           cudaStream_t stream) {
  if (Zc < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (ty == 8)
    return launch_tiled<EPI, RHO, 8>(u, flags, rho, ubc, uinv, out, B, Z, Y,
                                     X, YB, Zc, sc, stream);
  if (ty == 16)
    return launch_tiled<EPI, RHO, 16>(u, flags, rho, ubc, uinv, out, B, Z, Y,
                                      X, YB, Zc, sc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// u (B,3,Z,Y,X) f32, flags (B,1,Z,Y,X) int32, rho (B,1,Z,Y,X) f32.
// epi != 0, the prologue: ubc/uinv (B,3,Z,YB,X) f32 or null, out
// (B,4,Z,Y,X) f32. epi == 0, the forces block: ubc/uinv null, out
// (B,3,Z,Y,X) f32. scal7 = [bx, by, bz, gx, gy, gz, amp] as
// ops/cuda/forces_kernel.py builds it; ty, zc: the tile height (8 or 16)
// and output planes a block (forces_kernel.prologue_tiling). Returns
// cudaGetLastError().
extern "C" int fluidnet_prologue(const float* u, const int* flags,
                                 const float* rho, const float* ubc,
                                 const float* uinv, float* out, int B, int Z,
                                 int Y, int X, int YB, int epi, float bx,
                                 float by, float bz, float gx, float gy,
                                 float gz, float amp, int ty, int zc,
                                 void* stream) {
  const Scal sc{{bx, by, bz}, {gx, gy, gz}, amp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epi)
    return launch<true>(u, flags, rho, ubc, uinv, out, B, Z, Y, X, YB, ty,
                        zc, sc, st);
  return launch<false>(u, flags, rho, nullptr, nullptr, out, B, Z, Y, X, 0,
                       ty, zc, sc, st);
}

// K4: u (B,3,Z,Y,X) f32, flags (B,1,Z,Y,X) int32 -> out (B,3,Z,Y,X) f32,
// vorticity confinement of strength amp; ty, zc as above. Returns
// cudaGetLastError().
extern "C" int fluidnet_vorticity(const float* u, const int* flags,
                                  float* out, int B, int Z, int Y, int X,
                                  float amp, int ty, int zc, void* stream) {
  const Scal sc{{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, amp};
  return launch<false, false>(u, flags, nullptr, nullptr, nullptr, out, B,
                              Z, Y, X, 0, ty, zc, sc,
                              static_cast<cudaStream_t>(stream));
}
