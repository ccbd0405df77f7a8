"""Scale-out on torch.distributed: a ('dp', 'sp') DeviceMesh, the z-halo
Jacobi, z-sharded windowed advection, the whole z-sharded step and its
training, and multi-process data parallelism (port of
fluidnet_tpu.parallel)."""

from fluidnet_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                              spatial_sharding)
from fluidnet_tpu_torch.parallel.halo import halo_jacobi_solve
