"""Quickstart on the PyTorch port: the HiStore hybrid index in 60 seconds.

    python examples/quickstart_torch.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``, the same calls and
lines: one typed client over one index group (1 hash table + 2 sorted
replicas + logs): PUT / GET / SCAN / DELETE, a primary failure survived
mid-stream, and recovery, all through ``HiStoreClient``.  It runs on the
card (the CUDA kernels) unless ``--device`` names another device; with
``--device cpu`` the plain PyTorch path serves the same answers.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.histore import scaled  # noqa: E402
from repro_torch.core.client import HiStoreClient, LocalBackend  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

CFG = scaled(log_capacity=1 << 12, async_apply_batch=1024)


def main(device=None):
    client = HiStoreClient(LocalBackend(4096, CFG, device=device),
                           batch_quantum=64, apply_every_n_ops=2048)
    dev = client.backend.device

    # which index hot path serves this demo: "kernel" (the CUDA probe /
    # search / merge kernels, on the card) or "torch" (their plain
    # PyTorch versions, on the CPU): the route follows the device
    print(f"index hot path: {kops.active_path(CFG, dev)} "
          f"(use_kernels={CFG.use_kernels}, device={dev})")

    # PUT a batch (primary log -> backup logs -> hash table, §3.2.2)
    keys = np.random.RandomState(0).choice(10 ** 6, 500, replace=False)
    res = client.put(keys, np.arange(500))
    print(f"PUT 500 keys: ok={res.all_ok} retries={res.retries}")

    # GET: one-sided hash probe (1 sub-bucket read each), typed result
    g = client.get(keys[:8])
    print(f"GET hits={g.found.tolist()} accesses={g.accesses.tolist()} "
          f"values={g.values[:, 0].tolist()}")

    # SCAN: drains the async log, then walks the sorted replica
    s = client.scan(0, 10 ** 6, limit=10)
    print(f"SCAN first {int(s.count)} keys: {s.keys[:int(s.count)].tolist()}")

    # DELETE: tombstone through the log; compacts out of the replicas
    d = client.delete(keys[:4])
    g = client.get(keys[:8])
    print(f"DELETE 4: found={d.found.tolist()} -> GET now "
          f"hits={g.found.tolist()}")

    # failure: primary dies; GETs fall back to sorted replica + pending log
    client.fail_server(0)
    g = client.get(keys[4:8])
    print(f"degraded GET hits={g.found.tolist()} "
          f"accesses={g.accesses.tolist()}")

    # recovery: rebuild the hash table from a sorted replica (§4.3)
    client.recover_server(0)
    g = client.get(keys[4:8])
    print(f"post-recovery GET hits={g.found.tolist()} "
          f"accesses={g.accesses.tolist()}")
    assert g.all_found

    # telemetry: every op above was counted + histogrammed (the default
    # cfg.telemetry="counters"); scrape-ready Prometheus text
    print("\n--- client.metrics_text() ---")
    print(client.metrics_text())
    print("quickstart OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
