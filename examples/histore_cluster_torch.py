"""Distributed HiStore on the PyTorch port: 8 index groups on one device,
or over W ranks.

    python examples/histore_cluster_torch.py [--device cpu] [--ranks W]

The port's counterpart of ``examples/histore_cluster.py``, the same calls
and lines.  Each of the 8 groups has its primary on one index server and
a backup on each of two neighbours; the JAX package spreads them over 8
devices, the port's ``DistributedBackend`` stacks them on one, or with
``--ranks W`` (1, 2, 4 or 8) over W processes of 8 / W groups each
(``repro_torch.launch.ranks``: NCCL, one card a rank, or gloo on the CPU),
every rank making the same calls and rank 0 printing.  The same
``HiStoreClient`` front door as the single-node quickstart: one-sided
GETs (routed exchange + owner-side gathers), two-sided PUTs with log
replication, distributed DELETE tombstones, SCAN fan-out, and a
failover.  It runs on the card unless ``--device`` names another device.
"""
import argparse
import functools
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.histore import scaled  # noqa: E402
from repro_torch.core import kvstore as kv  # noqa: E402
from repro_torch.core.client import (DistributedBackend,  # noqa: E402
                                     HiStoreClient)
from repro_torch.launch import ranks  # noqa: E402

GROUPS = 8


def _np(t):
    return t.cpu().numpy()


def main(device=None, comm=None, say=print):
    cfg = scaled(log_capacity=512, async_apply_batch=128)
    n = GROUPS
    say(f"cluster: {n} index servers (1 group each, 2 backups)")
    client = HiStoreClient(
        DistributedBackend(n, cfg, 4096, capacity_q=64, scan_limit=64,
                           device=device, comm=comm),
        batch_quantum=64)

    keys = np.random.RandomState(1).choice(10 ** 6, 128, replace=False) + 1
    res = client.put(keys, np.arange(128))
    say(f"PUT 128: ok={res.all_ok} retries={res.retries}")

    g = client.get(keys[:16])
    say(f"GET 16: found={g.all_found} "
          f"max_accesses={int(_np(g.accesses).max())} "
          f"values_ok={bool((_np(g.values)[:, 0] == np.arange(16)).all())}")

    s = client.scan(0, 10 ** 7)
    ks = _np(s.keys)
    say(f"SCAN: first={int(ks[0])} "
          f"sorted={bool((np.diff(ks[:int(s.count)]) >= 0).all())}")

    d = client.delete(keys[:8])
    g2 = client.get(keys[:8])
    say(f"DELETE 8: found={bool(d.found.all())} -> GET misses="
          f"{not bool(g2.found.any())}")

    client.fail_server(3)          # index state wiped; data shard survives
    g3 = client.get(keys[8:])
    say(f"server 3 DOWN -> GET still found={g3.all_found}")
    w = client.put(keys + 10 ** 7, np.arange(128))
    rep = _np(w.replicas)
    say(f"PUT under failure: ok={w.all_ok} "
          f"replicas min/max={int(rep.min())}/{int(rep.max())} "
          f"(reduced replication reported honestly)")
    client.recover_server(3)       # hash rebuilt from replica, clones resync
    g4 = client.get(keys[8:])
    report = kv.parity_report(client.backend.store, cfg,
                              comm=client.backend.comm)
    say(f"server 3 RECOVERED -> GET found={g4.all_found} "
          f"parity={all(p['agree'] for p in report)}")
    say("cluster example OK")
    return client


def _rank_main(rank, world, device):
    main(device, ranks.comm(GROUPS, device),
         functools.partial(print, flush=True) if rank == 0
         else (lambda *a: None))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes, each holding 8 / W groups (default 1: "
                         "one process holds all 8)")
    args = ap.parse_args()
    if args.ranks == 1:
        main(args.device)
    else:
        ranks.spawn(_rank_main, args.ranks, device=args.device or "cuda",
                    timeout_s=600)
