"""The data-parallel group of the training path: W processes, one a rank,
joined in a ``torch.distributed`` process group (NCCL on the card, gloo
on the CPU; ``launch/ranks.py`` starts and joins them).

The JAX package trains SPMD over a ("data", "model") mesh: the step is
jitted with the batch sharded over "data" and the optimizer state
sharded over it too (ZeRO-1).  Here the W ranks are the data axis of the
mesh {"data": W, "model": 1}; the model axis over ranks (tensor and
expert parallelism, FSDP) is slice 9 of the port and raises.

    dp = DP(dist.group.WORLD, device)      # or DP.single(device)
    batch rows: dp.rows(global_batch)      # this rank's contiguous rows
    dp.sum_(t), dp.max_(t), dp.all_gather(t, dim), dp.gather(t),
    dp.broadcast(t, src),
    dp.shift(t, by)                        # the ring: rank r -> r + by
    dp.agree(x, op)                        # a host decision, int64

``rows`` is the split of JAX's ``batch_pspec`` plus
``make_array_from_callback``: W equal contiguous blocks where W divides
the global batch; where it does not, ``batch_pspec`` shards nothing and
every rank takes the whole batch (``shards`` says which).  ``DP.single``
is one process and calls no collective.  The store's group layout (G
groups over W ranks) is ``core/comm.py``'s; this module is the training
path's only.

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

SLICE9 = ("is slice 9 of the port (the mesh's model axis over ranks: "
          "tensor parallelism, moe_impl='smap', the sequence-sharded "
          "decode cache, FSDP); the JAX package does this work, the "
          "port does not yet")

class DP:
    """Rank, world, device and process group of the data axis.  ``mesh``
    (a dict, ``launch/mesh.py``) is checked against the group: its data
    axes must hold W devices and a model axis over 1 raises."""

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

    @property
    def mesh(self) -> dict:
        return {"data": self.world, "model": 1}

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


def check_mesh(mesh: dict, world: int):
    """A training mesh over ``world`` ranks: every rank on the data axes,
    a model axis of 1."""
    if mesh.get("model", 1) > 1:
        raise NotImplementedError(
            f"mesh {mesh}: a model axis over ranks {SLICE9}")
    data = 1
    for a in ("pod", "data"):
        data *= mesh.get(a, 1)
    if data != world:
        raise ValueError(f"mesh {mesh}: {data} devices on the data axes, "
                         f"{world} ranks")


def check_ranks(cfg, dp):
    """Raise for what training over ``dp`` needs of slice 9: the expert-
    parallel dispatch and FSDP over more than one rank."""
    if dp is None or dp.world == 1:
        return
    if cfg.moe_impl == "smap":
        raise NotImplementedError(
            f"{cfg.name}: moe_impl='smap' over {dp.world} ranks {SLICE9}")
    if cfg.fsdp:
        raise NotImplementedError(
            f"{cfg.name}: cfg.fsdp over {dp.world} ranks {SLICE9}")
