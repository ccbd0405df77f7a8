"""The projection prologue: everything between advection and the ConvNet.

Port of fluidnet_tpu.ops.prologue. The u-slab boundary condition, the
forces block (buoyancy, gravity, vorticity confinement), the slab BC again,
setWallBcs (incl. TypeStick) and the Manta-RHS divergence run as ONE pass:
kernel K2 (ops/cuda/forces_kernel.py, csrc/prologue.cu) on CUDA tensors,
the unfused composition `prologue_ref` on CPU tensors.
"""

import torch

from fluidnet_tpu_torch.ops.cuda.forces_kernel import (prologue_cuda,
                                                       prologue_plain)
from fluidnet_tpu_torch.ops.replay import replay

# The unfused reference composition (JAX: prologue_xla). Returns (u'', div).
prologue_ref = prologue_plain


def projection_prologue(u, flags, density, buoy_g, grav_g, amp, dt,
                        u_bc=None, u_inv=None, dx=None):
    """Fused (slab BC -> forces -> slab BC -> setWallBcs -> divergence).

    u (b,3,z,y,x) f32; flags (b,1,z,y,x) int32; density (b,1,z,y,x);
    buoy_g, grav_g: scaled gravity 3-vectors; amp: the (dx-scaled)
    confinement strength; dt: float; u_bc/u_inv: frozen slab masks
    (b,3,z,YB,x) or None; dx: the cell size (None: from the flags'
    shape). Returns (u'', div (b,1,z,y,x)).

    CPU tensors run prologue_ref; CUDA tensors launch K2, whose gradient
    with respect to u and density replays prologue_ref (the JAX custom VJP,
    prologue.py:98-105), the cotangent of div included."""
    if u.shape[1] != 3:
        raise NotImplementedError("the fused projection prologue is 3-D "
                                  "only, as in JAX: a 2-D step runs the "
                                  "unfused forces")
    if torch.as_tensor(buoy_g).dim() > 1 or \
            torch.as_tensor(grav_g).dim() > 1 or \
            torch.as_tensor(amp).dim() > 0:
        raise NotImplementedError("the fused projection prologue takes "
                                  "one force scale for the batch, as in "
                                  "JAX: per-sample (B,) scales run the "
                                  "unfused forces")
    if u.device.type == "cpu":
        return prologue_ref(u, flags, density, buoy_g, grav_g, amp, dt,
                            u_bc, u_inv, dx)
    return replay(
        lambda x, r: prologue_cuda(x, flags, r, buoy_g, grav_g, amp, dt,
                                   u_bc, u_inv, dx=dx),
        lambda x, r: prologue_ref(x, flags, r, buoy_g, grav_g, amp, dt, u_bc,
                                  u_inv, dx), u, density)
