"""NCCL's matching rule on the port's halo exchange (parallel/halo.py), on
the CPU in one process, without JAX or a process group.

NCCL ignores point-to-point tags: it pairs the i-th send from rank a to
rank b with the i-th receive on b from a, in the order they were posted.
Here n simulated ranks run in n threads of this process, and
torch.distributed's rank queries, P2POp and batch_isend_irecv are replaced
by a fabric that records each rank's posted operations and delivers them
that way once every rank has posted. Driven through exchange_ghost (the
z-sharded step's one-sided exchange) and its adjoint (planes_adjoint,
under autograd), for n = 2, 3 and 4 ranks and ghost zones of one plane, of
a whole slab, and past a slab (the planes of ranks two and three away):

  - every pair's sends and receives agree in count, shape and dtype;
  - each rank's extended slabs are the whole grid's planes around its own
    (a float, a second float and an int32 field, as the step exchanges
    u, density and the flags);
  - the adjoint adds each ghost plane's cotangent into its owner's own
    plane: every rank's gradient is the whole grid's sum of the
    cotangents laid on it (integer-valued float64, so the sums are exact).

A planted fault, one rank posting its operations in reverse order, must
fail these checks.

NCCL also takes one card a rank: parallel/mesh.nccl_card, select_device and
multihost.init_multihost refuse, with a ValueError naming the card count,
more ranks on a host than it has cards (checked with the card count
patched, before any process group exists), while gloo keeps sharing a
card.
"""

import threading

import pytest
import torch
import torch.distributed as dist

from fluidnet_tpu_torch.parallel import halo, mesh, multihost

B, Y, X = 1, 3, 2
ZL = 3
GHOSTS = {"one_plane": 1, "a_slab": ZL, "two_hops": ZL + 2,
          "three_hops": 2 * ZL + 1}


class Fabric:
    """n simulated ranks, one thread each. batch_isend_irecv records the
    calling rank's operations, waits for every rank's, and delivers as
    NCCL does: per (sender, receiver) pair, the i-th send into the i-th
    receive posted, tags ignored. `reversed_rank` posts its operations in
    reverse order (the planted fault). `problems` collects every pair
    whose sends and receives disagree in count, shape or dtype."""

    def __init__(self, n, reversed_rank=None):
        self.n, self.reversed_rank = n, reversed_rank
        self.local = threading.local()
        self.posted = [None] * n
        self.barrier = threading.Barrier(n, timeout=20)
        self.problems, self.batches = [], 0

    def get_rank(self, group=None):
        return self.local.rank

    def get_world_size(self, group=None):
        return self.n

    def get_global_rank(self, group, rank):
        return rank

    def P2POp(self, op, tensor, peer, group=None, tag=0):
        return op, tensor, peer, tag

    def batch_isend_irecv(self, ops):
        rank = self.local.rank
        self.posted[rank] = ops[::-1] if rank == self.reversed_rank \
            else list(ops)
        self.barrier.wait()
        if rank == 0:
            self._deliver()
        self.barrier.wait()
        return []

    def _deliver(self):
        self.batches += 1
        for a in range(self.n):
            for b in range(self.n):
                sends = [t for op, t, peer, _ in self.posted[a]
                         if op is dist.isend and peer == b]
                recvs = [t for op, t, peer, _ in self.posted[b]
                         if op is dist.irecv and peer == a]
                sig_s = [(tuple(t.shape), t.dtype) for t in sends]
                sig_r = [(tuple(t.shape), t.dtype) for t in recvs]
                if sig_s != sig_r:
                    self.problems.append((a, b, sig_s, sig_r))
                for s, r in zip(sends, recvs):
                    if s.shape == r.shape and s.dtype == r.dtype:
                        r.copy_(s)
        self.posted = [None] * self.n

    def run(self, fn):
        """fn(rank) on every simulated rank, each in its own thread.
        Returns [each rank's result]; re-raises a rank's exception."""
        out, errs = [None] * self.n, []

        def body(rank):
            self.local.rank = rank
            try:
                out[rank] = fn(rank)
            except BaseException as e:    # noqa: BLE001 (re-raised below)
                errs.append(e)
                self.barrier.abort()
        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


@pytest.fixture
def fabric(monkeypatch):
    """A factory of Fabrics patched into torch.distributed."""
    def make(n, reversed_rank=None):
        fab = Fabric(n, reversed_rank)
        for name in ("get_rank", "get_world_size", "get_global_rank",
                     "P2POp", "batch_isend_irecv"):
            monkeypatch.setattr(dist, name, getattr(fab, name))
        return fab
    return make


def _whole(n):
    """Three whole-grid fields of n slabs: two float64 (2 and 1
    channels) and an int32 one, integer-valued so every sum is exact."""
    gen = torch.Generator().manual_seed(7 + n)
    Z = n * ZL
    return [torch.randint(-50, 50, (B, c, Z, Y, X), generator=gen,
                          dtype=dtype)
            for c, dtype in ((2, torch.float64), (1, torch.float64),
                             (1, torch.int32))]


def _around(x, rank, g):
    """The whole grid's planes of x around rank's slab: g beyond each
    end, none past the grid's ends."""
    Z = x.shape[2]
    return x[:, :, max(rank * ZL - g, 0):min((rank + 1) * ZL + g, Z)]


def _exchange_checks(fab, n, g):
    """Each rank's exchange_ghost of the three fields, and the adjoint of
    the float ones; returns the checks that failed."""
    whole = _whole(n)
    gen = torch.Generator().manual_seed(100 + n * 10 + g)
    cots = [[torch.randint(-9, 9, _around(x, r, g).shape, generator=gen,
                           dtype=torch.float64) for x in whole[:2]]
            for r in range(n)]

    def rank_fn(rank):
        own = [x[:, :, rank * ZL:(rank + 1) * ZL].clone() for x in whole]
        ext = halo.exchange_ghost(own, g, None)
        floats = [x.requires_grad_() for x in own[:2]]
        grown = halo.exchange_ghost(floats, g, None)
        dot = sum((e * c).sum() for e, c in zip(grown, cots[rank]))
        grads = torch.autograd.grad(dot, floats)
        return [e.detach() for e in ext], [x.detach() for x in grads]

    results = fab.run(rank_fn)
    bad = list(fab.problems)
    # The adjoint: every rank's cotangents laid on the whole grid, summed.
    laid = [torch.zeros_like(x) for x in whole[:2]]
    for rank in range(n):
        for acc, c in zip(laid, cots[rank]):
            _around(acc, rank, g).add_(c)
    for rank, (ext, grads) in enumerate(results):
        for i, (e, x) in enumerate(zip(ext, whole)):
            if not torch.equal(e, _around(x, rank, g)):
                bad.append(("planes", rank, i))
        for i, (gr, acc) in enumerate(zip(grads, laid)):
            if not torch.equal(gr, acc[:, :, rank * ZL:(rank + 1) * ZL]):
                bad.append(("adjoint", rank, i))
    return bad


@pytest.mark.parametrize("ghost", list(GHOSTS))
@pytest.mark.parametrize("n", [2, 3, 4])
def test_exchange_pairs_in_posting_order(fabric, n, ghost):
    """exchange_ghost and its adjoint on n ranks, delivered by posting
    order per pair with tags ignored: every pair's sends and receives
    agree, every extended slab is the whole grid's planes around it, and
    every gradient the whole grid's sum of the cotangents on it. Three
    batches a rank: the forward exchange of the three fields, that of
    the two floats, its adjoint."""
    fab = fabric(n)
    assert _exchange_checks(fab, n, GHOSTS[ghost]) == []
    assert fab.batches == 3


@pytest.mark.parametrize("ghost", ["one_plane", "two_hops"])
def test_reversed_posting_order_fails(fabric, ghost):
    """The planted fault: rank 1 of 3 posts its sends and receives in
    reverse order. Its pairs' receives then take the wrong pieces: the
    checks above must fail (mismatched shapes, or planes and gradients
    that are not the whole grid's)."""
    fab = fabric(3, reversed_rank=1)
    bad = _exchange_checks(fab, 3, GHOSTS[ghost])
    assert bad
    assert any(b[0] == "planes" for b in bad)


# --- NCCL's one card a rank --------------------------------------------------


@pytest.fixture
def cards(monkeypatch):
    """Patches torch.cuda to `n` cards and records the cards set."""
    chosen = []

    def make(n):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
        for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
        return chosen
    return make


@pytest.mark.parametrize("local_world,n_cards", [(2, 1), (4, 2), (8, 4)])
def test_nccl_refuses_more_ranks_than_cards(cards, local_world, n_cards):
    """Under NCCL a host's ranks past its cards raise, naming the card
    count: nccl_card for every rank, select_device, and init_multihost
    before it creates a process group; a host with a card a rank gives
    rank r card r."""
    cards(n_cards)
    for r in range(local_world):
        with pytest.raises(ValueError, match=f"has {n_cards} CUDA card"):
            mesh.nccl_card(r, local_world, n_cards)
    with pytest.raises(ValueError, match=f"{local_world} ranks"):
        mesh.select_device("cuda", "nccl", local_world - 1, local_world)
    assert [mesh.nccl_card(r, n_cards, n_cards)
            for r in range(n_cards)] == list(range(n_cards))


def test_init_multihost_refuses_before_the_group(cards, monkeypatch):
    """init_multihost under NCCL with 4 ranks on a host of 2 cards raises
    before torch.distributed.init_process_group is reached; torchrun's
    LOCAL_RANK / LOCAL_WORLD_SIZE, where set, are what it counts."""
    chosen = cards(2)

    def unreachable(*a, **kw):
        raise AssertionError("init_process_group reached")
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group", unreachable)
    with pytest.raises(ValueError, match="has 2 CUDA card"):
        multihost.init_multihost("127.0.0.1:1", 4, 1, backend="nccl")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="4 ranks"):
        multihost.init_multihost("127.0.0.1:1", 8, 7, backend="nccl")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(AssertionError, match="reached"):
        multihost.init_multihost("127.0.0.1:1", 4, 3, backend="nccl")
    assert chosen == [1]


def test_gloo_shares_a_card(cards):
    """gloo keeps several ranks on one card: rank r on card r % count."""
    chosen = cards(1)
    for r in range(3):
        mesh.select_device("cuda", "gloo", r, 3)
    mesh.select_device("cpu", "nccl", 5, 8)
    assert chosen == [0, 0, 0]
