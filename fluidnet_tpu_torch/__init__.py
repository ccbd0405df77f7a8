"""fluidnet_tpu_torch: the PyTorch + CUDA port of fluidnet_tpu (Hopper).

A second package beside the JAX reference (`fluidnet_tpu`), written for one
H100. Plain tensor code is PyTorch; every Pallas TPU kernel on the ported
path is a CUDA C++ kernel written by hand for sm_90a (`csrc/`), built with
nvcc at first use and bound with ctypes (`ops/cuda/`). Each kernel keeps a
plain PyTorch version beside it, which is what runs when its tensors lie on
the CPU.

Ported so far: the 3-D plume rollout (`sim.simulate.rollout` with
maccormackOurs advection) with the ConvNet projection (the fused
projection prologue and any ConvNet the config builds, optionally
followed by Jacobi polish sweeps) and with the Jacobi and PCG solvers
(`solvers/`); the 2-D step of the interactive demo (`cli/serve.py`,
`cli/demo2d.py`: windowed advection on the warp kernel, the 2-D ConvNet,
the adaptive window); training (`cli/train.py`, fed by the device cache
or, past it, by the threaded host loader; `native/` is the C++ host
runtime of frame reads, binvox decoding and the flood fill), the offline 3-D
simulation (`cli/sim3d.py`), the statistics (`cli/stats.py`) and the
scale-out layer on torch.distributed (`parallel/`: the z-sharded Jacobi
and advection, data-parallel training across processes).
Constructors build on the CUDA device unless given
device="cpu". Layout, argument order and semantics follow the JAX
package: every field is a 5-D (batch, channel, z, y, x) tensor.

This package never imports jax, flax, msgpack or fluidnet_tpu.
"""

from fluidnet_tpu_torch.core.celltype import CellType
from fluidnet_tpu_torch.core.grids import FluidState

__version__ = "0.1.0"
