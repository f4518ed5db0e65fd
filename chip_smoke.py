#!/usr/bin/env python3
"""Drive the PyTorch port of HiStore on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--keys 8388608]

1. Prints the card (torch and nvidia-smi).
2. Builds the CUDA kernels of src/repro_torch/kernels/csrc with nvcc.
3. The main path: HiStoreClient(LocalBackend(2**24, DEFAULT)) on the
   card with the paper's shapes, loaded with ``--keys`` distinct int32
   keys, then 8 mixed rounds of one client chunk (16384 keys) each: GETs
   (hits and misses), overwriting and fresh PUTs, DELETEs, an async
   apply and 4 SCANs (limit 128).  Every
   answer is checked against a sorted-array model kept here: every
   acknowledged write reads back with its value, deleted keys are not
   found, every SCAN equals the model's range.  The kernels' launch
   counts are set to 0 just before this phase and must all be > 0 after.
4. Each kernel against its plain PyTorch version on the card, on the
   loaded state at the main path's shapes (equality of every output),
   with its time per call (CUDA events), its device time (launches
   queued behind a GPU sleep, so host time is hidden), its plain
   version's time, its bound (bytes over 3.35 TB/s; for the search also
   the latency of its dependent levels) and, for the search,
   torch.searchsorted.
5. The last two lines: the kernels as JSON, then the device as JSON.

Exits nonzero, printing no result, without CUDA or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA's data sheet
CAPACITY = 1 << 24
ROUNDS = 8                       # mixed rounds after the load
CHUNK = 16384                    # the client's max_batch: one chunk per op
SCANS = 4                        # SCANs per mixed round
FUSED = "src/repro/kernels/_fused.py"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg):
    print(msg, flush=True)


class Model:
    """The reference: a sorted array of every key the run may touch,
    with a live mask and the values — a dict + sorted list in arrays."""

    def __init__(self, keys, words):
        self.keys = np.sort(keys)
        self.live = np.zeros(len(self.keys), bool)
        self.vals = np.zeros((len(self.keys), words), np.int32)

    def at(self, keys):
        i = np.searchsorted(self.keys, keys)
        check(np.array_equal(self.keys[i], keys), "model key lookup")
        return i

    def put(self, keys, vals):
        i = self.at(keys)
        self.live[i] = True
        self.vals[i] = vals

    def delete(self, keys):
        self.live[self.at(keys)] = False

    def _find(self, keys):
        i = np.minimum(np.searchsorted(self.keys, keys), len(self.keys) - 1)
        return self.keys[i] == keys, i

    def known(self, keys):
        return self._find(keys)[0]

    def is_live(self, keys):
        hit, i = self._find(keys)
        return hit & self.live[i], i

    def scan(self, lo, hi, limit):
        a = np.searchsorted(self.keys, lo, side="left")
        b = np.searchsorted(self.keys, hi, side="right")
        ks = self.keys[a:b][self.live[a:b]]
        return ks[:limit]


def time_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(torch, fn, iters, sleep_cycles=int(3e8)):
    """Device time per call of ``fn``: its launches are queued behind a
    GPU sleep, so they run back to back and the host's time between them
    is hidden.  Checks that the host queued them all within the sleep."""
    fn()
    torch.cuda.synchronize()
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    e[0].record()
    torch.cuda._sleep(sleep_cycles)
    e[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    e[2].record()
    torch.cuda.synchronize()
    check(host_ms < e[0].elapsed_time(e[1]),
          f"device_ms: queueing took {host_ms:.3f} ms, longer than the sleep")
    return e[1].elapsed_time(e[2]) / iters


def max_abs_err(torch, got, want, label):
    err = 0
    for i, (x, y) in enumerate(zip(got, want)):
        check(x.shape == y.shape, f"{label}: output {i} shape")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        e = int(d.max()) if d.numel() else 0
        check(e == 0, f"{label}: output {i} differs from the plain version "
                      f"(max abs err {e})")
        err = max(err, e)
    return float(err)


def main_path(torch, args, cfg, rng):
    from repro_torch.core.client import HiStoreClient, LocalBackend
    from repro_torch.kernels import ops

    W = cfg.value_words
    n_load = args.keys
    n_fresh = ROUNDS * CHUNK // 2
    need = n_load + n_fresh
    uniq = np.unique(rng.integers(0, 2 ** 31 - 1, int(need * 1.02) + 1024))
    check(len(uniq) >= need, "not enough distinct keys drawn")
    keys_all = uniq[rng.permutation(len(uniq))[:need]].astype(np.int32)
    load_keys, fresh = keys_all[:n_load], keys_all[n_load:]
    model = Model(keys_all, W)

    def absent(n):
        out = np.empty(0, np.int32)
        while len(out) < n:
            c = rng.integers(0, 2 ** 31 - 1, 2 * n).astype(np.int32)
            out = np.concatenate([out, c[~model.known(c)]])
        return out[:n]

    def sample(keys, n):
        """n distinct entries of ``keys`` (a full permutation of 8 M keys,
        as rng.choice(replace=False) makes, costs about a second)."""
        i = np.unique(rng.integers(0, len(keys), 2 * n))
        check(len(i) >= n, "sample: not enough distinct draws")
        return keys[rng.permutation(i)[:n]]

    def new_vals(n):
        return rng.integers(1, 2 ** 31 - 1, (n, W)).astype(np.int32)

    def check_get(client, keys, label):
        r = client.get(keys)
        want_found, i = model.is_live(keys)
        found = r.found.cpu().numpy()
        check(np.array_equal(found, want_found),
              f"{label}: found differs on {(found != want_found).sum()} keys")
        vals = r.values.cpu().numpy()
        check(np.array_equal(vals[found], model.vals[i[found]]),
              f"{label}: values differ")
        check(not vals[~found].any(), f"{label}: values on a miss")
        return int(found.sum())

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = LocalBackend(CAPACITY, cfg, device="cuda")
    client = HiStoreClient(backend)
    torch.cuda.synchronize()
    log(f"main: LocalBackend({CAPACITY}) created in "
        f"{time.perf_counter() - t0:.3f} s, "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated")
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0

    # -- load ------------------------------------------------------------
    t0 = time.perf_counter()
    vals = new_vals(n_load)
    r = client.put(load_keys, vals)
    ok = r.ok.cpu().numpy()
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(ok.all(), f"load: {(~ok).sum()} PUTs not acknowledged")
    model.put(load_keys, vals)
    log(f"main: loaded {n_load} keys in {t_load:.3f} s "
        f"({n_load / t_load:.0f} PUT/s, retries {r.retries})")

    # -- mixed rounds: one client chunk of each op per round ---------------
    B = CHUNK
    check(client.max_batch == B, f"client chunk {client.max_batch}")
    fresh_at = 0
    stats = {"get_hits": 0, "gets": 0, "puts": 0, "deletes": 0,
             "deleted_found": 0, "scans": 0, "scanned": 0}
    t0 = time.perf_counter()
    for rnd in range(ROUNDS):
        live_keys = model.keys[model.live]
        dead_keys = model.keys[~model.live]
        dead = (rng.choice(dead_keys, B // 4) if len(dead_keys)
                else absent(B // 4))
        g = np.concatenate([rng.choice(live_keys, B // 2), dead,
                            absent(B - B // 2 - B // 4)])
        rng.shuffle(g)
        stats["get_hits"] += check_get(client, g, f"round {rnd} GET")
        stats["gets"] += len(g)
        p = np.concatenate([sample(live_keys, B // 2),
                            fresh[fresh_at:fresh_at + B // 2]])
        fresh_at += B // 2
        pv = new_vals(len(p))
        r = client.put(p, pv)
        check(bool(r.ok.all()), f"round {rnd}: PUT not acknowledged")
        model.put(p, pv)
        stats["puts"] += len(p)
        live_keys = model.keys[model.live]
        d = np.concatenate([sample(live_keys, 3 * B // 16),
                            absent(B // 16)])
        rng.shuffle(d)
        want, _ = model.is_live(d)
        r = client.delete(d)
        check(bool(r.ok.all()), f"round {rnd}: DELETE not acknowledged")
        check(np.array_equal(r.found.cpu().numpy(), want),
              f"round {rnd}: DELETE found differs")
        model.delete(d[want])
        stats["deletes"] += len(d)
        stats["deleted_found"] += int(want.sum())
        client.apply()
        for _ in range(SCANS):
            lo = int(rng.choice(model.keys))
            hi = lo + int(rng.integers(1, 2 ** 16))
            s = client.scan(lo, hi, 128)
            n = int(s.count)
            want_keys = model.scan(lo, hi, 128)
            check(n == len(want_keys) and np.array_equal(
                s.keys[:n].cpu().numpy(), want_keys),
                f"round {rnd}: SCAN [{lo}, {hi}] differs")
            stats["scans"] += 1
            stats["scanned"] += n
        check_get(client, d, f"round {rnd} GET after DELETE")
    torch.cuda.synchronize()
    t_mixed = time.perf_counter() - t0

    # -- every acknowledged write reads back -------------------------------
    t0 = time.perf_counter()
    hits = check_get(client, model.keys, "final read-back")
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    check(hits == int(model.live.sum()), "final read-back count")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"main: {ROUNDS} mixed rounds in {t_mixed:.3f} s: {stats}")
    log(f"main: read back {len(model.keys)} keys ({hits} live) in "
        f"{t_read:.3f} s ({len(model.keys) / t_read:.0f} GET/s)")
    log(f"main: launches {launches}")
    log(f"main: torch.cuda.max_memory_allocated() = {peak} B "
        f"({peak / 2**30:.3f} GiB)")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    m = client.metrics()
    log(f"main: telemetry {json.dumps(m.counters, sort_keys=True)} "
        f"gauges {json.dumps(m.gauges, sort_keys=True)}")
    for op, lat in sorted(m.latency.items()):
        log(f"main: latency {op}: {lat.count} calls, mean "
            f"{lat.mean * 1e3:.3f} ms, p50 <= {lat.p50 * 1e3:.3f} ms, "
            f"p99 <= {lat.p99 * 1e3:.3f} ms, max {lat.max * 1e3:.3f} ms")
    return backend, model, launches


def compare_kernels(torch, backend, model, cfg, rng, launches):
    from repro_torch.core import hash_index as hix
    from repro_torch.core import sorted_index as six
    from repro_torch.kernels import ops

    dev = backend.device
    g = backend.group
    out = []

    # -- hash probe, Q = 16384 (one client chunk) ---------------------------
    Q = 16384
    live = model.keys[model.live]
    dead = model.keys[~model.live]
    q = np.concatenate([rng.choice(live, Q // 2), rng.choice(dead, Q // 4),
                        rng.integers(0, 2 ** 31 - 1, Q - Q // 2 - Q // 4)])
    qt = torch.as_tensor(q.astype(np.int32), device=dev)
    tomb = int((g.hash.sig == hix.TOMBSTONE).sum())
    err = max_abs_err(torch, ops.probe(cfg, g.hash, qt),
                      hix.lookup(g.hash, qt, cfg), "hash_probe routed")
    b, s, f = hix.descriptors(g.hash, qt)
    tab = (g.hash.sig, g.hash.fp, g.hash.addr, g.hash.fill)

    def kern():
        return ops.hash_probe_cuda(b, s, f, *tab, cfg.slots_per_bucket)

    got = kern()
    err = max(err, max_abs_err(
        torch, (got[0], got[1].bool(), got[2]),
        hix.probe_rows(g.hash, b, s, f, cfg), "hash_probe"))
    ms = time_ms(torch, kern, 200)
    dev_ms = device_ms(torch, kern, 200)
    plain = time_ms(torch, lambda: hix.probe_rows(g.hash, b, s, f, cfg), 50)
    routed = time_ms(torch, lambda: ops.probe(cfg, g.hash, qt), 200)
    plain_routed = time_ms(torch, lambda: hix.lookup(g.hash, qt, cfg), 50)
    cs = g.hash.sig.shape[1]
    # 3 descriptors in, 3 outputs, the sig and fp rows, one addr, one fill
    nbytes = Q * (12 + 12 + 2 * cs * 4 + 8)
    log(f"kernel hash_probe: Q={Q}, table [{g.hash.sig.shape[0]}, {cs}] with "
        f"{tomb} tombstones: equal; kernel {ms:.4f} ms per call, device "
        f"{dev_ms:.4f} ms, plain {plain:.4f} ms; routed ops.probe (hashing "
        f"included) {routed:.4f} ms, plain lookup {plain_routed:.4f} ms; "
        f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms ({nbytes} B)")
    out.append(dict(name="hash_probe", route="cuda",
                    source="src/repro_torch/kernels/csrc/hash_probe.cu",
                    replaces=f"{FUSED}:204", launches=launches["hash_probe"],
                    max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, device_ms=dev_ms,
                    routed_ms=routed, plain_routed_ms=plain_routed))

    # -- sorted search: Q = 1 (the SCAN lower bound) and Q = 16384 ----------
    # Latency bound: `levels` dependent node reads.  One level's device time
    # is the slope between this index and a one-level index (its first
    # fanout keys) at Q = 1; the nodes sit in L2 after the warm-up.
    srt = g.sorted[0]
    levels = six.directory_levels(srt.keys.shape[0], cfg.fanout)
    top = (srt.keys[:cfg.fanout].clone(), srt.addrs[:cfg.fanout].clone())
    res = {}
    for QS in (1, 16384):
        sq = np.concatenate([rng.choice(live, QS - QS // 2),
                             rng.integers(0, 2 ** 31 - 1, QS // 2)])
        sqt = torch.as_tensor(sq.astype(np.int32), device=dev)
        got = ops.sorted_search_cuda(sqt, srt.keys, srt.addrs, cfg.fanout)
        want_lb = torch.searchsorted(srt.keys, sqt).to(torch.int32)
        err = max_abs_err(torch, (got[0], got[1].bool(), got[2], got[4]),
                          (*six.search(srt, sqt, cfg.fanout), want_lb),
                          f"sorted_search Q={QS}")
        iters = 500 if QS == 1 else 100

        def kern(keys=srt.keys, addrs=srt.addrs):
            return ops.sorted_search_cuda(sqt, keys, addrs, cfg.fanout)

        ms = time_ms(torch, kern, iters)
        dev_ms = device_ms(torch, kern, iters)
        plain = time_ms(torch, lambda: six.search(srt, sqt, cfg.fanout),
                        iters // 5)
        lib = time_ms(torch, lambda: torch.searchsorted(srt.keys, sqt), iters)
        nbytes = QS * (4 + levels * cfg.fanout * 4 + 8 + 5 * 4)
        lat = None
        if QS == 1:
            level_ms = (dev_ms - device_ms(torch, lambda: kern(*top), iters)
                        ) / (levels - 1)
            lat = levels * level_ms
        res[QS] = (err, ms, dev_ms, plain, lib, nbytes, lat)
        log(f"kernel sorted_search: Q={QS}, cap {srt.keys.shape[0]}, "
            f"{levels} levels: equal; {ms:.4f} ms per call, device "
            f"{dev_ms:.4f} ms, plain {plain:.4f} ms, torch.searchsorted "
            f"{lib:.4f} ms, bound {nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms "
            f"({nbytes} B)" + ("" if lat is None else
                               f", latency bound {lat:.6f} ms"))
    err, ms, dev_ms, plain, lib, nbytes, lat = res[1]
    out.append(dict(name="sorted_search", route="cuda",
                    source="src/repro_torch/kernels/csrc/sorted_search.cu",
                    replaces=f"{FUSED}:246",
                    launches=launches["sorted_search"], max_abs_err=err,
                    ms=ms, plain_ms=plain,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=lib, device_ms=dev_ms,
                    latency_bound_ms=lat))

    # -- merge: cap = 2^24, m = 4096 ----------------------------------------
    m = cfg.async_apply_batch
    bk = np.concatenate([rng.choice(live, m // 2),
                         rng.integers(0, 2 ** 31 - 1, m - m // 2)])
    bk[: m // 8] = bk[m // 8: m // 4]                  # duplicate keys
    rng.shuffle(bk)
    bo = rng.choice([0, 1, 1, 2], m).astype(np.int8)   # PUT, DEL, op 0
    bkt = torch.as_tensor(bk.astype(np.int32), device=dev)
    bat = torch.as_tensor(rng.integers(0, CAPACITY, m).astype(np.int32),
                          device=dev)
    bot = torch.as_tensor(bo, device=dev)
    got = ops.merge(cfg, srt, bkt, bat, bot)
    want = six.merge(srt, bkt, bat, bot)
    err = max_abs_err(torch, tuple(got), tuple(want), "merge")
    ms = time_ms(torch, lambda: ops.merge(cfg, srt, bkt, bat, bot), 20)
    dev_ms = device_ms(torch, lambda: ops.merge(cfg, srt, bkt, bat, bot), 20)
    plain = time_ms(torch, lambda: six.merge(srt, bkt, bat, bot), 5)
    cap = srt.keys.shape[0]
    nbytes = cap * 8 + m * 12 + cap * 8 + 4
    log(f"kernel merge: cap {cap} (size {int(srt.size)} -> "
        f"{int(got.size)}), m={m}: equal; {ms:.4f} ms per call, device "
        f"{dev_ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms ({nbytes} B)")
    out.append(dict(name="merge", route="cuda",
                    source="src/repro_torch/kernels/csrc/merge.cu",
                    replaces=f"{FUSED}:404", launches=launches["merge"],
                    max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, device_ms=dev_ms))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=1 << 23,
                    help="distinct keys loaded before the mixed rounds")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.histore import DEFAULT
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"device: {name}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, count {torch.cuda.device_count()}")

    _build.build()
    log(f"build: {_build.BUILD_INFO['seconds']:.2f} s, compiled "
        f"{_build.BUILD_INFO['compiled']} into {_build.BUILD_INFO['dir']}")

    cfg = DEFAULT
    log(f"config: {cfg}")
    rng = np.random.default_rng(args.seed)
    backend, model, launches = main_path(torch, args, cfg, rng)
    kernels = compare_kernels(torch, backend, model, cfg, rng, launches)
    torch.cuda.synchronize()
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
