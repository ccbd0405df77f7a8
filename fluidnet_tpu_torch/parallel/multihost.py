"""Multi-host (multi-process) distribution.

Port of fluidnet_tpu.parallel.multihost. The reference is single-process
and single-GPU (SURVEY.md §2.3); the scale-out here is two-level: the
('dp', 'sp') dims inside a host (parallel/mesh.py) and data parallelism
across hosts. In the port every rank is a process:

  - `init_multihost()` initialises the default process group from its
    arguments or from torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK): NCCL for the card, gloo for the CPU.
  - `make_global_mesh(n_dp, n_sp)` builds a ('host', 'dp', 'sp')
    DeviceMesh whose leading dim spans the hosts (WORLD_SIZE /
    LOCAL_WORLD_SIZE of them; torchrun numbers a host's ranks
    contiguously), 'dp' and 'sp' the ranks inside each host.
  - `shard_host_batch(batch, mesh)` gives each rank its part of its
    host's LOCAL batch: every host feeds its own data, as JAX's
    make_array_from_process_local_data does.

Where GSPMD inserts the gradient psum over 'host' and 'dp' by itself
(multihost.py:21-23), the port's train_step takes the data-parallel group
(mesh.data_parallel_group) and averages gradients and loss terms over it
with all_reduce; everything else in the step is unchanged.
"""

import os
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from fluidnet_tpu_torch.parallel.mesh import (Sharding, select_device,
                                              shard_batch)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device_type: str = "cuda",
                   backend: Optional[str] = None) -> bool:
    """Initialises the default process group when there is more than one
    process. `coordinator_address` is host:port (else MASTER_ADDR and
    MASTER_PORT), `num_processes` the world size (else WORLD_SIZE),
    `process_id` the rank (else RANK). The backend is `backend`, else NCCL
    on 'cuda' and gloo on 'cpu' (gloo on 'cuda' lets several ranks share
    one card, which NCCL refuses). Under NCCL on 'cuda' the rank takes
    its card (LOCAL_RANK) before the group exists, and a host whose ranks
    exceed its cards raises ValueError naming the card count
    (mesh.nccl_card). Returns True if the group was initialised (or
    already was), False when running single-process (a no-op)."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or num_processes is None \
            or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("init_multihost: no process id (pass process_id "
                         "or set RANK)")
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend == "nccl":
        select_device(device_type, backend, process_id, num_processes)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def make_global_mesh(n_dp: Optional[int] = None, n_sp: int = 1,
                     device_type: str = "cuda") -> DeviceMesh:
    """A ('host', 'dp', 'sp') DeviceMesh over the default group: 'host'
    spans WORLD_SIZE / LOCAL_WORLD_SIZE hosts, 'dp' x 'sp' the
    LOCAL_WORLD_SIZE ranks of each (every host the same count, as on the
    JAX side). On 'cuda' each rank takes a card (mesh.select_device;
    under NCCL a card of its own, else ValueError)."""
    if not dist.is_initialized():
        raise RuntimeError("make_global_mesh: no process group; call "
                           "init_multihost first")
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"make_global_mesh: world {world} is not a "
                         f"multiple of LOCAL_WORLD_SIZE {local}")
    if n_dp is None:
        n_dp = local // n_sp
    if n_dp * n_sp != local:
        raise ValueError(f"make_global_mesh: dp {n_dp} x sp {n_sp} is not "
                         f"the {local} ranks of a host")
    select_device(device_type)
    return init_device_mesh(device_type, (world // local, n_dp, n_sp),
                            mesh_dim_names=("host", "dp", "sp"))


def global_batch_sharding(mesh: DeviceMesh) -> Sharding:
    """(b, c, z, y, x): b over host x dp, z over sp."""
    return Sharding(mesh, (("host", "dp"), None, "sp", None, None))


# A host's LOCAL batch splits over its 'dp' ranks and z over 'sp' as
# shard_batch splits a batch (batch_sharding names only 'dp' and 'sp'); the
# global batch is the hosts' local batches in host order.
shard_host_batch = shard_batch
