"""Device mesh and sharding helpers on torch.distributed.

Port of fluidnet_tpu.parallel.mesh. The reference is single-process and
single-GPU (SURVEY.md §2.3); this is the scale-out layer it never had: a
('dp', 'sp') DeviceMesh over the ranks of the default process group,

  dp: data parallel over the batch axis (independent scenes),
  sp: spatial decomposition over the grid's z axis (grids past one card).

The port runs SPMD: one process per rank, each holding its own slice of a
tensor. Where JAX's GSPMD inserts collectives from sharding annotations,
the port spells every exchange out: the sharded functions
(parallel/halo.py, parallel/advect_sharded.py, parallel/simulate_sharded.py,
parallel/train_sharded.py) exchange z-planes on the 'sp' group,
train_step(group=) averages the gradients over the data-parallel group
(`data_parallel_group`), and train_step(mesh=) sums them over 'sp' and
averages them over 'dp'. A sharding here is only a
description: which mesh dims split which tensor axis; `local_part` cuts
this rank's slice by it.

Host staging: the gloo backend moves host tensors (its point-to-point ops
take no CUDA tensor), so every collective of this package stages a CUDA
tensor through the host exactly when the group's backend is gloo
(`host_staged`), and several gloo ranks may share a card; under NCCL the
card's tensors go as they are, one card a rank (`select_device` refuses
more ranks than a host has cards), and `barrier` names the card.
"""

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


class Sharding(NamedTuple):
    """How a tensor lies on `mesh`: spec[i] is None (axis i whole on every
    rank), a mesh dim name, or a tuple of names (split over their product,
    the first name major)."""
    mesh: DeviceMesh
    spec: tuple


def make_mesh(n_dp: Optional[int] = None, n_sp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ('dp', 'sp') DeviceMesh over the initialised default group; rank
    r sits at (r // n_sp, r % n_sp), as device r of JAX's make_mesh. On
    'cuda' each rank takes a card (select_device; under NCCL a card of
    its own, else ValueError)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.multihost.init_multihost first")
    world = dist.get_world_size()
    if n_dp is None:
        n_dp = world // n_sp
    if n_dp * n_sp != world:
        raise ValueError(f"make_mesh: dp {n_dp} x sp {n_sp} is not the "
                         f"world size {world}")
    select_device(device_type)
    return init_device_mesh(device_type, (n_dp, n_sp),
                            mesh_dim_names=("dp", "sp"))


def nccl_card(local_rank: int, local_world: int, n_cards: int) -> int:
    """The card of local rank `local_rank` of a host's `local_world` ranks
    under NCCL, which refuses two ranks on one card: card local_rank.
    Raises ValueError, naming the card count, when the host's ranks
    exceed its cards (two of them would share one)."""
    if local_world > n_cards or not 0 <= local_rank < n_cards:
        raise ValueError(
            f"NCCL needs a card a rank: this host has {n_cards} CUDA "
            f"card(s) for {max(local_world, local_rank + 1)} ranks, so "
            f"two ranks would share one (local rank {local_rank} has no "
            f"card of its own); start at most {n_cards} ranks a host, or "
            f"use the gloo backend, which shares a card")
    return local_rank


def select_device(device_type: str, backend: Optional[str] = None,
                  rank: Optional[int] = None, world: Optional[int] = None):
    """Sets this rank's card on 'cuda'. `backend` (else the default
    group's) NCCL: card LOCAL_RANK (nccl_card: ValueError when the host's
    ranks exceed its cards), whatever card the process used before.
    gloo: unless this process already uses a card, card LOCAL_RANK (else
    its rank) modulo the card count, so that several ranks share one card
    when there are more ranks than cards (DeviceMesh would take card
    LOCAL_RANK, which need not exist). `rank` and `world` stand for the
    default group's before it exists."""
    if device_type != "cuda":
        return
    if backend is None:
        backend = dist.get_backend()
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                    if rank is None else rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     dist.get_world_size()
                                     if world is None else world))
    if backend == "nccl":
        torch.cuda.set_device(nccl_card(local_rank, local_world,
                                        torch.cuda.device_count()))
    elif not torch.cuda.is_initialized():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def barrier(group=None):
    """dist.barrier on `group`, on this rank's card under NCCL (which
    otherwise guesses the card from the rank)."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


def batch_sharding(mesh: DeviceMesh) -> Sharding:
    """(b, c, z, y, x): b over dp, z over sp."""
    return Sharding(mesh, ("dp", None, "sp", None, None))


def spatial_sharding(mesh: DeviceMesh) -> Sharding:
    """Pure spatial decomposition (one scene too big for one card)."""
    return Sharding(mesh, (None, None, "sp", None, None))


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, ())


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_part(x, sharding: Sharding) -> torch.Tensor:
    """This rank's slice of the global tensor `x` (a view where it can
    be). Raises ValueError when an axis does not divide over its dims."""
    mesh, spec = sharding
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    x = torch.as_tensor(x)
    for axis, dims in enumerate(spec):
        if dims is None:
            continue
        dims = (dims,) if isinstance(dims, str) else tuple(dims)
        count, index = 1, 0
        for d in dims:
            i = names.index(d)
            count *= mesh.shape[i]
            index = index * mesh.shape[i] + coord[i]
        n = x.shape[axis]
        if n % count:
            raise ValueError(f"axis {axis} of {tuple(x.shape)} ({n}) must "
                             f"divide over {'x'.join(dims)} ({count})")
        x = x.narrow(axis, index * (n // count), n // count)
    return x


def shard_batch(batch: dict, mesh: DeviceMesh, device=None) -> dict:
    """This rank's part of a global host batch, on `device` (else its
    device on the mesh): b split over dp, z over sp (batch_sharding),
    non-5-D entries passed through (mesh.py:46-50)."""
    if device is None:
        device = mesh_device(mesh)
    sharding = batch_sharding(mesh)
    return {k: local_part(v, sharding).to(device).contiguous()
            if getattr(v, "ndim", 0) == 5 else v for k, v in batch.items()}


def data_parallel_group(mesh: DeviceMesh):
    """The process group over the mesh's batch dims ('host' and 'dp'):
    the ranks that share this rank's 'sp' coordinate, over which
    train_step(group=) averages the gradients. Every rank must call it
    (it creates one group per 'sp' coordinate)."""
    names = mesh.mesh_dim_names
    if "sp" not in names:
        raise ValueError(f"data_parallel_group: mesh dims {names} have no "
                         f"'sp'")
    ranks = mesh.mesh.movedim(names.index("sp"), -1)
    ranks = ranks.reshape(-1, ranks.shape[-1]).T.tolist()
    if len(ranks) == 1:
        return dist.group.WORLD
    group, _ = dist.new_subgroups_by_enumeration(ranks)
    return group


def host_staged(x: torch.Tensor, group) -> bool:
    """Whether a collective on `group` stages `x` through the host: a CUDA
    tensor under gloo."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def transport(x: torch.Tensor, group) -> str:
    """How this package's collectives move `x` on `group`: 'nccl', 'gloo'
    or 'gloo, host-staged'."""
    backend = dist.get_backend(group)
    return f"{backend}, host-staged" if host_staged(x, group) else backend


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    """`op` of `x` over the ranks of `group`, on x's device (x itself is
    left as it is)."""
    if host_staged(x, group):
        buf = x.cpu()
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(x.device)
    buf = x.clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf


class _AllReduceSum(torch.autograd.Function):
    """all_reduce_sum under autograd: the cotangent of the sum is every
    rank's, so the backward is the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group, dist.ReduceOp.SUM), \
            None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, on x's device.
    Differentiable: under autograd the backward all_reduces the cotangent
    (every rank must then run the backward)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `x` over the ranks of `group`, on x's
    device."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)
