"""One process a rank: the distributed store over ``torch.distributed``.

    from repro_torch.launch import ranks

    def body(rank, world, device, *args):     # importable: it is pickled
        comm = ranks.comm(8, device)          # G = 8 groups over the ranks
        ...
        return result                         # picklable

    results = ranks.spawn(body, 4, device="cpu", timeout_s=120)

``spawn`` starts ``world`` processes with the spawn start method; they
meet through a ``FileStore`` in a temporary directory (never a fixed TCP
port, so that runs side by side do not collide) and join a process group
with a timeout: NCCL with rank r on ``cuda:r`` for ``device="cuda"``,
gloo on the CPU for ``device="cpu"``.  ``backend="gloo"`` with
``device="cuda"`` puts every rank on the card too (``cuda:r`` modulo the
card count), for a gloo that takes CUDA tensors.  A rank's exception, a
rank that dies, or a run past ``timeout_s`` fails the call, with every
rank stopped.  Nothing falls back: a CUDA run whose NCCL group fails to
form raises.  On the card the kernels are built once in the caller
first, so that W ranks do not each run ``nvcc``.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` set) a script calls ``init_from_env``
in each process instead.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch


def _backend(device: str, backend) -> str:
    if backend is not None:
        return backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_device(device: str, backend: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("a CUDA rank needs a card; none is visible")
    if backend == "nccl" and rank >= n:
        raise RuntimeError(f"NCCL rank {rank} needs cuda:{rank}; "
                           f"{n} cards are visible")
    return torch.device("cuda", rank % n)


def init(rank: int, world: int, *, device: str = "cuda", backend=None,
         store_path=None, timeout_s: float = 300.0) -> torch.device:
    """Join the process group as ``rank`` of ``world``: through the
    ``FileStore`` at ``store_path``, or torchrun's environment
    (``env://``) when it is None.  Returns this rank's device."""
    import torch.distributed as dist
    backend = _backend(device, backend)
    dev = _rank_device(device, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)     # W ranks share the host's cores
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        kw["device_id"] = dev            # the communicator formed at once
    if store_path is None:
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(store=dist.FileStore(store_path, world), **kw)
    return dev


def init_from_env(device: str = "cuda", backend=None,
                  timeout_s: float = 300.0) -> tuple:
    """Join torchrun's process group.  Returns (rank, world, device)."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if int(os.environ.get("LOCAL_RANK", rank)) != rank:
        raise RuntimeError("one host only: RANK and LOCAL_RANK differ")
    return rank, world, init(rank, world, device=device, backend=backend,
                             timeout_s=timeout_s)


def comm(G: int, device):
    """The Comm of the G groups over the default process group."""
    import torch.distributed as dist

    from repro_torch.core.comm import Comm
    return Comm(G, dist.group.WORLD, device)


def _worker(fn, rank, world, device, backend, store_path, timeout_s, args,
            results):
    import torch.distributed as dist
    try:
        dev = init(rank, world, device=device, backend=backend,
                   store_path=store_path, timeout_s=timeout_s)
        out = fn(rank, world, dev, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:   # noqa: BLE001 -- reported to the caller
        results.put((rank, False, traceback.format_exc()))


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)


def spawn(fn, world: int, *, device: str = "cuda", backend=None,
          timeout_s: float = 300.0, args: tuple = ()) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes
    joined in one process group; returns the ranks' results in rank
    order.  Raises RuntimeError with a rank's traceback when one fails,
    dies or the run passes ``timeout_s``."""
    import multiprocessing as mp
    backend = _backend(device, backend)
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="histore-ranks-") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, name=f"histore-rank-{r}",
                             args=(fn, r, world, device, backend, store_path,
                                   timeout_s, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, error = {}, None
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world and error is None:
                try:
                    rank, ok, res = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        error = (f"rank {dead[0]} exited with code "
                                 f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        error = (f"{world} ranks did not finish in "
                                 f"{timeout_s} s (done: {sorted(out)})")
                    continue
                if ok:
                    out[rank] = res
                else:
                    error = f"rank {rank} failed:\n{res}"
            if error is None:
                for p in procs:
                    p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            _stop(procs)
            results.close()
    if error is not None:
        raise RuntimeError(error)
    return [out[r] for r in range(world)]
