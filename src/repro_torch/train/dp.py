"""The data-parallel group of the training path: W processes, one a rank,
joined in a ``torch.distributed`` process group (NCCL on the card, gloo
on the CPU; ``launch/ranks.py`` starts and joins them).

The JAX package trains SPMD over a ("data", "model") mesh: the step is
jitted with the batch sharded over "data", the optimizer state sharded
over it too (ZeRO-1), and the weights over "model" (tensor and expert
parallelism).  Here a ``DP`` is one axis's group, and ``Ranks`` the mesh
{"data": d, "model": m} over W = d * m ranks: rank r sits at data index
r // m and model index r % m, the device order of
``jax.make_mesh((d, m), ("data", "model"))``.  Its data group is the d
ranks of one model index, its model group the m consecutive ranks of
one data index.

    dp = DP(dist.group.WORLD, device)      # or DP.single(device)
    batch rows: dp.rows(global_batch)      # this rank's contiguous rows
    dp.split(global_batch, seq_len)        # (rows, sequence slice or None)
    dp.sum_(t), dp.max_(t), dp.all_gather(t, dim), dp.gather(t),
    dp.reduce_scatter(t, dim), dp.reduce_to(t, owner),
    dp.broadcast(t, src),
    dp.shift(t, by)                        # the ring: rank r -> r + by
    dp.agree(x, op)                        # a host decision, int64

``rows`` is the split of JAX's ``batch_pspec`` plus
``make_array_from_callback``: W equal contiguous blocks where W divides
the global batch; where it does not, ``batch_pspec`` shards nothing and
every rank takes the whole batch (``shards`` says which).  At a global
batch of 1 JAX's ``input_pspecs`` cuts the sequence over the data axis
instead: ``split`` gives each rank the contiguous block [r S / W,
(r + 1) S / W) of the sequence, and raises ValueError where W does not
divide S, as ``make_array_from_callback`` does.  ``DP.single`` is one
process and calls no collective.

FSDP (``cfg.fsdp``, ``sharding/fsdp.py``) gathers a parameter's slices
with ``all_gather`` and sums their gradients with ``reduce_scatter``; a
layer held by one rank goes out by ``broadcast`` and its gradient comes
back by ``reduce_to``.  gloo has no reduce-scatter, so there the first
is one ``all_to_all_single`` and a sum in rank order on each receiver;
``reduce_to`` is that on every backend (the one receiver sums).

The store's group layout (G groups over W ranks) is ``core/comm.py``'s;
this module is the training path's only.

``sharding/context.use_dp(dp)`` sets the group that the model's
collectives read while the loss and its gradient are taken, as the JAX
package's ``sharding/context.use_mesh`` sets its mesh: the MoE router's
statistics and capacity are global (``models/moe.py``).  The layers that
``remat="unit"`` checkpoints recompute their forward in the backward, on
autograd's own thread on the card, so the group is one slot of the
process, which every thread reads.
"""
from __future__ import annotations

from collections import Counter

import torch

class DP:
    """Rank, world, device and process group of one mesh axis (the data
    axis, unless ``Ranks`` makes it the model axis).  ``mesh`` (a dict,
    ``launch/mesh.py``) is checked against the group: it must hold W
    devices."""

    def __init__(self, group=None, device=None, mesh=None):
        if group is None:
            rank, world = 0, 1
        else:
            import torch.distributed as dist
            rank, world = dist.get_rank(group), dist.get_world_size(group)
        self.group, self.rank, self.world = group, rank, world
        self.device = torch.device(device) if device is not None else None
        if mesh is not None:
            check_mesh(mesh, world)
        self.stats = {"calls": Counter(), "bytes": Counter()}

    @classmethod
    def single(cls, device=None) -> "DP":
        return cls(None, device)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def __repr__(self):
        return f"DP(rank={self.rank}, world={self.world}, {self.device})"

    def reset_stats(self):
        self.stats = {"calls": Counter(), "bytes": Counter()}

    def _count(self, verb: str, nbytes: int):
        self.stats["calls"][verb] += 1
        self.stats["bytes"][verb] += int(nbytes)

    # -- the batch -----------------------------------------------------------
    def shards(self, global_batch: int) -> bool:
        """Whether the batch is split over the ranks (JAX's
        ``batch_pspec`` is nonempty)."""
        return global_batch % self.world == 0

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of the global batch: a contiguous block, or
        every row where W does not divide the batch."""
        if not self.shards(global_batch):
            return slice(0, global_batch)
        n = global_batch // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def split(self, global_batch: int, seq_len: int) -> tuple:
        """(this rank's rows, its block of the sequence or None): the
        sequence is cut where JAX's ``input_pspecs`` cuts it over the
        data axis (no batch split, a global batch of 1, a sequence
        longer than 1).  Raises ValueError where W does not divide the
        sequence there."""
        rows = self.rows(global_batch)
        if (self.world == 1 or self.shards(global_batch)
                or global_batch != 1 or seq_len <= 1):
            return rows, None
        if seq_len % self.world:
            raise ValueError(
                f"the sequence of {seq_len} positions is cut over a data "
                f"axis of {self.world} at batch 1, which does not divide "
                f"it (the JAX package's make_array_from_callback raises "
                f"too)")
        n = seq_len // self.world
        return rows, slice(self.rank * n, (self.rank + 1) * n)

    # -- collectives ----------------------------------------------------------
    def _reduce(self, t, op: str):
        if not self.distributed:
            return t
        import torch.distributed as dist
        self._count(f"all_reduce_{op}", t.numel() * t.element_size())
        dist.all_reduce(t, {"sum": dist.ReduceOp.SUM,
                            "max": dist.ReduceOp.MAX}[op], group=self.group)
        return t

    def sum_(self, t):
        """All-reduce sum of ``t`` over the ranks, in place; ``t``."""
        return self._reduce(t, "sum")

    def max_(self, t):
        """All-reduce max of ``t`` over the ranks, in place; ``t``."""
        return self._reduce(t, "max")

    def all_gather(self, t, dim: int = 0):
        """Every rank's ``t`` (one shape on every rank) concatenated
        along ``dim`` in rank order."""
        if not self.distributed:
            return t
        import torch.distributed as dist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        self._count("all_gather", t.numel() * t.element_size() * self.world)
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim)

    def gather(self, t):
        """Every rank's ``t`` (one shape on every rank) on rank 0, in rank
        order: a list there, None on the others.  One
        ``all_to_all_single`` whose only receiver is rank 0, which gloo
        runs on CUDA tensors too."""
        if not self.distributed:
            return [t]
        import torch.distributed as dist
        send = t.contiguous().view(-1)
        n, W, root = send.numel(), self.world, self.rank == 0
        recv = torch.empty(n * W if root else 0, dtype=send.dtype,
                           device=send.device)
        self._count("gather", n * send.element_size())
        dist.all_to_all_single(recv, send, [n if root else 0] * W,
                               [n if q == 0 else 0 for q in range(W)],
                               group=self.group)
        return list(recv.view((W,) + tuple(t.shape)).unbind(0)) if root \
            else None

    def _gloo(self) -> bool:
        import torch.distributed as dist
        return dist.get_backend(self.group) == "gloo"

    def reduce_scatter(self, t, dim: int = 0):
        """The ranks' ``t`` (one shape on every rank, ``dim`` a multiple
        of W) summed, this rank's block along ``dim``: W equal
        contiguous blocks in rank order.  On gloo one
        ``all_to_all_single`` of the blocks and their sum in rank order;
        on NCCL ``reduce_scatter_tensor``."""
        if not self.distributed:
            return t
        import torch.distributed as dist
        W = self.world
        n = t.shape[dim] // W
        send = t.movedim(dim, 0).contiguous()
        self._count("reduce_scatter", send.numel() * send.element_size())
        if not self._gloo():
            out = torch.empty((n,) + send.shape[1:], dtype=t.dtype,
                              device=t.device)
            dist.reduce_scatter_tensor(out, send, group=self.group)
            return out.movedim(0, dim)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        parts = recv.view((W, n) + send.shape[1:])
        out = parts[0].clone()
        for q in range(1, W):
            out += parts[q]
        return out.movedim(0, dim)

    def reduce_to(self, t, owner: int):
        """The ranks' ``t`` (one shape on every rank) summed on rank
        ``owner``, in rank order; None on the other ranks.  One
        ``all_to_all_single`` whose only receiver is the owner, which
        gloo runs on CUDA tensors too."""
        if not self.distributed:
            return t
        import torch.distributed as dist
        send = t.contiguous().view(-1)
        n, W, mine = send.numel(), self.world, self.rank == owner
        recv = torch.empty(n * W if mine else 0, dtype=send.dtype,
                           device=send.device)
        self._count("reduce_to", n * send.element_size())
        dist.all_to_all_single(recv, send, [n if mine else 0] * W,
                               [n if q == owner else 0 for q in range(W)],
                               group=self.group)
        if not mine:
            return None
        parts = recv.view((W,) + tuple(t.shape))
        out = parts[0].clone()
        for q in range(1, W):
            out += parts[q]
        return out

    def all_gather_into(self, outs: list, t):
        """Rank r's ``t`` into ``outs[r]`` (tensors of ``t``'s shape and
        dtype, such as the layers of a stack, each rank's own one
        included)."""
        if not self.distributed:
            outs[0].copy_(t)
            return
        import torch.distributed as dist
        self._count("all_gather", t.numel() * t.element_size() * self.world)
        dist.all_gather(outs, t.contiguous(), group=self.group)

    def shift(self, t, by: int = 1):
        """``ppermute`` along the ring of the ranks: this rank's ``t``
        goes to rank + by, and rank - by's (one shape on every rank)
        comes back.  One ``all_to_all_single`` with split sizes, which
        gloo runs on CUDA tensors too."""
        by %= self.world
        if not self.distributed or by == 0:
            return t.clone()
        import torch.distributed as dist
        send = t.contiguous().view(-1)
        recv = torch.empty_like(send)
        n = send.numel()
        out_rows = [n if q == (self.rank - by) % self.world else 0
                    for q in range(self.world)]
        in_rows = [n if q == (self.rank + by) % self.world else 0
                   for q in range(self.world)]
        self._count("shift", n * send.element_size())
        dist.all_to_all_single(recv, send, out_rows, in_rows,
                               group=self.group)
        return recv.view(t.shape)

    def broadcast(self, t, src: int = 0):
        """Rank ``src``'s ``t`` into every rank's ``t``, in place."""
        if not self.distributed:
            return t
        import torch.distributed as dist
        self._count("broadcast", t.numel() * t.element_size())
        dist.broadcast(t, dist.get_global_rank(self.group, src),
                       group=self.group)
        return t

    def agree(self, x, op: str = "max"):
        """All ranks' ``x`` (a host decision: a scalar or a small vector)
        reduced by ``op`` ("max", "min" or "sum"), as an int64 tensor;
        ``x`` itself, as one, on one process."""
        t = torch.as_tensor(x, device=self.device).to(torch.int64)
        if not self.distributed:
            return t
        import torch.distributed as dist
        shape = t.shape
        t = t.reshape(-1).clone()
        self._count("all_reduce_agree", t.numel() * t.element_size())
        dist.all_reduce(t, {"max": dist.ReduceOp.MAX,
                            "min": dist.ReduceOp.MIN,
                            "sum": dist.ReduceOp.SUM}[op], group=self.group)
        return t.reshape(shape)

    def barrier(self):
        if self.distributed:
            import torch.distributed as dist
            dist.barrier(group=self.group)


class Ranks:
    """The mesh {"data": d, "model": m} over ``dp``'s W = d * m ranks:
    ``all`` (every rank: the weights' broadcast, host decisions,
    barriers), ``data`` and ``model`` (this rank's groups), ``mesh``,
    ``rank`` and ``device``.  Every rank makes every group, in one order
    (the data groups, then the model groups); an axis of one rank is
    ``DP.single`` and calls no collective; a data axis of every rank is
    ``dp`` itself, and a model axis of every rank runs over ``dp``'s
    group with counts of its own.  A "pod" axis folds into the data
    axis."""

    def __init__(self, dp: DP, mesh: dict | None = None):
        mesh = dict(mesh) if mesh is not None else {"data": dp.world,
                                                    "model": 1}
        mesh.setdefault("model", 1)
        check_mesh(mesh, dp.world)
        m = mesh["model"]
        d = dp.world // m
        self.all, self.mesh, self.device = dp, mesh, dp.device
        self.rank = dp.rank
        i, j = coords(self.rank, mesh)
        single = DP.single(dp.device)
        if m == 1:
            self.data, self.model = (dp if d > 1 else single), single
            return
        if d == 1:
            self.data, self.model = single, DP(dp.group, dp.device)
            return
        import torch.distributed as dist
        glob = [dist.get_global_rank(dp.group, r) for r in range(dp.world)]
        data = [dist.new_group([glob[a * m + b] for a in range(d)])
                for b in range(m)]
        model = [dist.new_group(glob[a * m:(a + 1) * m]) for a in range(d)]
        self.data, self.model = DP(data[j], dp.device), DP(model[i],
                                                          dp.device)

    @property
    def distributed(self) -> bool:
        return self.all.distributed

    @property
    def world(self) -> int:
        return self.all.world

    @property
    def coords(self) -> tuple:
        """(data index, model index) of this rank."""
        return self.data.rank, self.model.rank

    def __repr__(self):
        return f"Ranks(rank={self.rank}, mesh={self.mesh}, {self.device})"


def coords(rank: int, mesh: dict) -> tuple:
    """(data index, model index) of ``rank`` on ``mesh``: JAX's
    ``make_mesh`` device order, the model index fastest."""
    m = mesh.get("model", 1)
    return rank // m, rank % m


def check_mesh(mesh: dict, world: int):
    """A training mesh over ``world`` ranks: its axes hold them all."""
    n = 1
    for a in ("pod", "data", "model"):
        n *= mesh.get(a, 1)
    if n != world:
        raise ValueError(f"mesh {mesh}: {n} devices on its axes, "
                         f"{world} ranks")
