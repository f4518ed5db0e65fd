"""The distributed store's collectives over W ranks (the port's
counterpart of the JAX package's ``shard_map`` axis).

The store has G index groups.  Rank r of a ``torch.distributed`` process
group holds the L = G / W consecutive groups [g0, g0 + L), g0 = r L, as
the leading [L] axis of every sharded leaf ([R, L] for the backups);
W = G is JAX's layout of one group a device.  The verbs of
``verbs.py`` and the control plane of ``kvstore.py`` go through a
``Comm``:

  exchange       JAX's ``all_to_all``: the [L, G c, ...] exchange
                 buffers, viewed as [L, W, L, c], one
                 ``all_to_all_single`` a field;
  shift          JAX's ``ppermute`` by +s along the ring of groups: the
                 rows that leave a rank reach at most two ranks, one
                 ``all_to_all_single`` with split sizes;
  all_gather     JAX's ``all_gather`` along the group axis;
  group_leaves   one group's state, broadcast from its owner (the
                 host-side control plane reads survivors through it);
  to_owners      rows sent to the rank that owns each row's group (the
                 allocator's sweep sends each slot mark to its shard):
                 an all_gather of the counts, then one
                 ``all_to_all_single`` with split sizes;
  move           point-to-point copies of whole tensors from one
                 group's owner to another's (a data shard rebuilt from
                 a mirror), one ``all_to_all_single`` a leaf, with
                 split sizes that leave every other rank out;
  psum           an all-reduce sum, which brings rows from the one rank
                 that holds each to every rank;
  agree          an all-reduce of a host decision, so that every rank
                 takes the same branch before the next collective.

``Comm.single(G)`` has no process group: all G groups on one device, the
exchange a transpose, the shift a ``torch.roll``, ``all_gather`` and
``group_leaves`` indexing, ``to_owners`` and ``move`` the tensors
themselves.  No collective is called on that path.

``host()`` is a second Comm over the same ranks on a gloo group of its
own, on the CPU: the lease ticker's rounds run there, off the store's
op stream, so its collectives never pair with the store's.

Every collective counts its calls and the bytes this rank sends
(``stats``), by kind.  Bool tensors travel as uint8.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch


def _wire(x):
    """x as a contiguous tensor the backends take (bool viewed as
    uint8)."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


class Comm:
    """G groups over the ranks of ``group`` (None: one process holds
    them all).  ``device`` is where this rank's tensors live."""

    def __init__(self, G: int, group=None, device=None):
        if group is None:
            rank, world = 0, 1
        else:
            import torch.distributed as dist
            rank, world = dist.get_rank(group), dist.get_world_size(group)
        if G < 1 or G % world:
            raise ValueError(f"{G} groups do not divide over {world} ranks")
        self.G, self.group, self.rank, self.world = G, group, rank, world
        self.L = G // world
        self.g0 = rank * self.L
        self.device = torch.device(device) if device is not None else None
        self.stats = {"calls": Counter(), "bytes": Counter()}
        self._plans = {}
        self._host = None

    @classmethod
    def single(cls, G: int) -> "Comm":
        return cls(G)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def __repr__(self):
        return (f"Comm(G={self.G}, rank={self.rank}, world={self.world}, "
                f"L={self.L}, g0={self.g0})")

    # -- ownership -----------------------------------------------------------
    def owner(self, g: int) -> int:
        return int(g) // self.L

    def owns(self, g: int) -> bool:
        return self.g0 <= int(g) < self.g0 + self.L

    def local(self, g: int) -> int:
        """Group g's row in this rank's stack; raises where another rank
        owns it."""
        if not self.owns(g):
            raise IndexError(f"group {g} lives on rank {self.owner(g)}, "
                             f"not on rank {self.rank}")
        return int(g) - self.g0

    def loc(self, x):
        """This rank's rows of a replicated [G, ...] vector."""
        return x[self.g0:self.g0 + self.L] if self.distributed else x

    def rows(self, x):
        """Global lanes [B, ...] -> this rank's [L, B / G, ...]: group d
        holds lanes [d B / G, (d + 1) B / G), as JAX's P("kv") gives
        them."""
        x = x.reshape((self.G, -1) + tuple(x.shape[1:]))
        return self.loc(x)

    def lanes(self, x):
        """This rank's [L, n, ...] lanes -> the global [G n, ...], in
        group order on every rank."""
        x = self.all_gather(x)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    # -- collectives ---------------------------------------------------------
    def _count(self, kind: str, nbytes: int):
        self.stats["calls"][kind] += 1
        self.stats["bytes"][kind] += int(nbytes)

    def reset_stats(self):
        self.stats = {"calls": Counter(), "bytes": Counter()}

    def _a2a(self, x, out_rows=None, in_rows=None, kind="all_to_all"):
        """all_to_all_single of x along dim 0 (equal chunks, or the split
        sizes given), counted under ``kind``; returns the received
        tensor."""
        import torch.distributed as dist
        send = _wire(x)
        n = send.shape[0] if out_rows is None else sum(out_rows)
        recv = send.new_empty((n,) + tuple(send.shape[1:]))
        self._count(kind, send.numel() * send.element_size())
        dist.all_to_all_single(recv, send, out_rows, in_rows,
                               group=self.group)
        return recv.view(torch.bool) if x.dtype == torch.bool else recv

    def exchange(self, bufs: dict) -> dict:
        """``all_to_all`` of a dict of [L, G c, ...] buffers (forward or
        reverse): group d's chunk j goes to group j's chunk d."""
        out = {}
        G, L, W = self.G, self.L, self.world
        for name, arr in bufs.items():
            c = arr.shape[1] // G
            tail = tuple(arr.shape[2:])
            if not self.distributed:
                out[name] = (arr.reshape((G, G, c) + tail).transpose(0, 1)
                             .reshape(arr.shape))
                continue
            # [L src, W, L dst, c] -> [W, L src, L dst, c]: chunk w to rank w
            send = arr.reshape((L, W, L, c) + tail).transpose(0, 1)
            recv = self._a2a(send)           # [W src rank, L src, L dst, c]
            out[name] = recv.movedim(2, 0).reshape(arr.shape)
        return out

    def _shift_plan(self, s: int, dev):
        """(send order, send rows a rank, recv rows a rank, recv order)
        of the global roll by s, made once a shift and device.  Each
        chunk travels in its rows' destination order: the sender sorts
        by (rank, group) of the destination, the receiver's rows arrive
        by (source rank, group)."""
        plan = self._plans.get((s, dev))
        if plan is None:
            G, L, W, g0 = self.G, self.L, self.world, self.g0
            i = np.arange(L)
            dest = (g0 + i + s) % G
            to_rank = dest // L
            from_rank = ((g0 + i - s) % G) // L
            plan = (torch.as_tensor(np.lexsort((dest, to_rank)), device=dev),
                    np.bincount(to_rank, minlength=W).tolist(),
                    np.bincount(from_rank, minlength=W).tolist(),
                    torch.as_tensor(np.argsort(from_rank, kind="stable"),
                                    device=dev))
            self._plans[(s, dev)] = plan
        return plan

    def shift(self, x, s: int):
        """``ppermute`` by +s along the ring of the G groups: group d's
        row lands at d + s.  ``x`` is a tensor or a dict of tensors with
        the leading [L] axis."""
        if isinstance(x, dict):
            return {k: self.shift(v, s) for k, v in x.items()}
        if not self.distributed:
            return torch.roll(x, s, dims=0)
        s %= self.G
        if s == 0:
            return x
        send_order, in_rows, out_rows, recv_order = self._shift_plan(
            s, x.device)
        recv = self._a2a(x[send_order], out_rows, in_rows)
        out = torch.empty_like(recv)
        out[recv_order] = recv
        return out

    def all_gather(self, x, axis: int = 0):
        """[..., L, ...] (the group axis at ``axis``) -> [..., G, ...],
        in group order on every rank."""
        if not self.distributed:
            return x
        import torch.distributed as dist
        y = _wire(x.movedim(axis, 0))
        parts = [torch.empty_like(y) for _ in range(self.world)]
        self._count("all_gather", y.numel() * y.element_size())
        dist.all_gather(parts, y, group=self.group)
        out = torch.cat(parts).movedim(0, axis)
        return out.view(torch.bool) if x.dtype == torch.bool else out

    def gather_tree(self, state, axis: int = 0):
        """``all_gather`` of every leaf of a NamedTuple state."""
        return type(state)(*[self.all_gather(leaf, axis) for leaf in state])

    def group_leaves(self, state, g: int):
        """Group g's state (a NamedTuple whose leaves have the leading
        [L] axis) on every rank, broadcast from its owner: the host-side
        control plane reads survivors through it."""
        if not self.distributed:
            return type(state)(*[leaf[g] for leaf in state])
        import torch.distributed as dist
        src = dist.get_global_rank(self.group, self.owner(g))
        out = []
        for leaf in state:
            if self.owns(g):
                buf = _wire(leaf[self.local(g)])
            else:
                buf = _wire(leaf.new_empty(tuple(leaf.shape[1:])))
            self._count("broadcast", buf.numel() * buf.element_size()
                        if self.owns(g) else 0)
            dist.broadcast(buf, src, group=self.group)
            out.append(buf.view(torch.bool) if leaf.dtype == torch.bool
                       else buf)
        return type(state)(*out)

    def to_owners(self, x, groups):
        """Each row of ``x`` [n, ...] to the rank that owns group
        ``groups[i]`` (a [n] tensor of global groups): returns the rows
        this rank received, by source rank, each source's rows in their
        order.  Counts travel first (an all_gather of [W] a rank).
        ``x`` itself on one process."""
        if not self.distributed:
            return x
        dest = torch.div(groups, self.L, rounding_mode="floor").long()
        order = torch.argsort(dest, stable=True)
        sent = torch.bincount(dest, minlength=self.world)
        counts = self.all_gather(sent[None])            # [W src, W dst]
        return self._a2a(x[order], counts[:, self.rank].tolist(),
                         sent.tolist(), kind="to_owners")

    def move(self, moves, like):
        """Copies of whole tensors between groups' owners.  ``moves`` is
        a list of (source group, destination group, tensors), the
        tensors a tuple shaped like ``like`` on the source's owner (None
        on every other rank; ``like`` is a tuple of tensors of each
        leaf's shape and dtype, on every rank).  Returns, for each move,
        its tuple on the destination's owner and None elsewhere.  The
        plan is the same on every rank; a move within a rank copies
        nothing, the others take one ``all_to_all_single`` a leaf in
        which only their two ranks send or receive.  On one process
        every move is within the rank."""
        out = [None] * len(moves)
        remote = []
        for i, (s, d, t) in enumerate(moves):
            if self.owner(s) != self.owner(d):
                remote.append(i)
            elif self.owns(d):
                out[i] = t
        if not remote:
            return out
        send = sorted((self.owner(moves[i][1]), i) for i in remote
                      if self.owns(moves[i][0]))
        recv = sorted((self.owner(moves[i][0]), i) for i in remote
                      if self.owns(moves[i][1]))
        in_rows = np.bincount(np.asarray([r for r, _ in send], np.int64),
                              minlength=self.world)
        out_rows = np.bincount(np.asarray([r for r, _ in recv], np.int64),
                               minlength=self.world)
        got = [[] for _ in recv]
        for j, t0 in enumerate(like):
            x = (torch.stack([moves[i][2][j] for _, i in send]) if send
                 else t0.new_empty((0,) + tuple(t0.shape)))
            y = self._a2a(x, out_rows.tolist(), in_rows.tolist(),
                          kind="move")
            for k in range(len(recv)):
                got[k].append(y[k])
        for k, (_, i) in enumerate(recv):
            out[i] = tuple(got[k])
        return out

    def host(self) -> "Comm":
        """This Comm's ranks on a gloo group of their own, on the CPU
        (itself on one process): host decisions taken off the store's op
        stream (the lease ticker's rounds) go through it, so that their
        collectives never pair with the store's.  Made at the first call,
        which every rank makes (``new_group`` is collective)."""
        if not self.distributed:
            return self
        if self._host is None:
            import datetime

            import torch.distributed as dist
            g = dist.new_group(dist.get_process_group_ranks(self.group),
                               backend="gloo",
                               timeout=datetime.timedelta(seconds=60))
            self._host = Comm(self.G, g, "cpu")
        return self._host

    def psum(self, x):
        """JAX's ``psum`` over the ranks, in x's own dtype: the rank
        that holds a row contributes it and the others zeros, so every
        rank gets each row exactly.  ``x`` itself on one process."""
        if not self.distributed:
            return x
        import torch.distributed as dist
        t = x.contiguous().clone()
        self._count("all_reduce", t.numel() * t.element_size())
        dist.all_reduce(t, dist.ReduceOp.SUM, group=self.group)
        return t

    def agree(self, x, op: str = "max"):
        """All ranks' ``x`` (a host decision: a scalar or a small
        vector) reduced by ``op`` ("max", "min" or "sum"), as int64;
        ``x`` itself on one process."""
        if not self.distributed:
            return x
        import torch.distributed as dist
        t = torch.as_tensor(x, device=self.device)
        shape = t.shape
        t = t.to(torch.int64).reshape(-1).clone()
        self._count("all_reduce", t.numel() * t.element_size())
        dist.all_reduce(t, {"max": dist.ReduceOp.MAX,
                            "min": dist.ReduceOp.MIN,
                            "sum": dist.ReduceOp.SUM}[op], group=self.group)
        return t.reshape(shape)
