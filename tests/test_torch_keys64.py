"""The port's store on int64 keys, held bit for bit against the JAX
package under ``jax_enable_x64`` (its x64 deployment, where
``hashing.key_dtype()`` is int64).

x64 is a process-wide switch, so JAX's side runs in ONE subprocess under
``JAX_ENABLE_X64=1 JAX_PLATFORMS=cpu`` (``tests/_keys64_jax.py``), started
by a module-scoped fixture; its inputs, answers and states come back in
an ``.npz`` and every case below holds the port to them, values and
dtypes: the hashes; ``ops.probe`` / ``search`` / ``range_query`` /
``merge`` / ``backup_probe`` on an int64 group at ``use_kernels="on"``;
``HiStoreClient(LocalBackend(key_dtype=torch.int64))`` over
``gen_ops`` traces drawn from [1, 2**62]; a primary failure with its
online rebuild and a backup failure with its re-clone; a JAX backend
carried across in mid-failure and continued; and the serving engine's
page directory on int64 keys (page keys, stats and tokens).

The cases marked ``requires_cuda`` hold each int64 CUDA entry point
against its plain version on the card and skip here.  This module
imports no JAX (``tests/oracle.py`` does, so the JAX-held cases import
it where they run), so those cases also run on a machine without it:

    PYTHONPATH=src:tests python -m pytest -q -m requires_cuda \
        tests/test_torch_keys64.py
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _keys64_jax as J
from repro_torch import convert
from repro_torch.configs.histore import scaled
from repro_torch.configs.tiny import tiny_config
from repro_torch.core import hash_index as hi
from repro_torch.core import hashing as hs
from repro_torch.core import index_group as ig
from repro_torch.core import log as lg
from repro_torch.core import sorted_index as si
from repro_torch.core import tree
from repro_torch.core.client import HiStoreClient, LocalBackend
from repro_torch.kernels import ops
from repro_torch.serving import engine as eng

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
I64 = torch.int64
CFG = scaled(**J.TRACE_KW)


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """JAX's answers under x64: (arrays by name, the JSON records, the
    serving model's weights)."""
    out = tmp_path_factory.mktemp("keys64") / "jax.npz"
    env = {**os.environ, "JAX_ENABLE_X64": "1", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, str(HERE / "_keys64_jax.py"),
                        str(out)], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    with np.load(out) as z:
        a = {k: z[k] for k in z.files}
    js = json.loads(str(a.pop("json")))
    with open(f"{out}.params.pkl", "rb") as f:
        params = pickle.load(f)
    return SimpleNamespace(a=a, js=js, params=params)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(got, want, what):
    """Equal values and an equal dtype."""
    g, w = _np(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype}, JAX's {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=what)


def _jgroup(a, prefix):
    """JAX's IndexGroup of ``prefix`` as the attribute tree
    ``convert.group_from_numpy`` reads."""
    def part(name, cls):
        return SimpleNamespace(**{f: a[f"{prefix}/{name}/{f}"]
                                  for f in cls._fields})
    return SimpleNamespace(hash=part("hash", hi.HashIndex),
                           plog=part("plog", lg.UpdateLog),
                           sorted=part("sorted", si.SortedIndex),
                           blogs=part("blogs", lg.UpdateLog),
                           alive=a[f"{prefix}/alive"])


def _group_eq(g, a, prefix):
    """Every leaf of the port's group equals JAX's, dtype included."""
    for name in ("hash", "plog"):
        st = getattr(g, name)
        for f, x in zip(st._fields, st):
            _same(x, a[f"{prefix}/{name}/{f}"], f"{prefix} {name}.{f}")
    for name, states in (("sorted", g.sorted), ("blogs", g.blogs)):
        for r, st in enumerate(states):
            for f, x in zip(st._fields, st):
                _same(x, a[f"{prefix}/{name}/{f}"][r],
                      f"{prefix} {name}[{r}].{f}")
    _same(g.alive, a[f"{prefix}/alive"], f"{prefix} alive")


def _obs(obs):
    """Observations as JSON gives JAX's back (tuples become lists)."""
    return json.loads(json.dumps(obs))


def _client(max_batch=16384):
    return HiStoreClient(LocalBackend(J.TRACE_CAP, CFG, device="cpu",
                                      key_dtype=I64),
                         batch_quantum=J.QUANTUM, max_batch=max_batch)


def _parity(g, cfg):
    """The port's side of ``_keys64_jax.parity``."""
    g = ig.drain(g, cfg)
    items, agree = [], []
    for srt in g.sorted:
        keys, addrs, valid = si.items(srt)
        a_h, f_h, _ = hi.lookup(g.hash, keys, cfg)
        items.append(int(valid.sum()))
        agree.append(bool(f_h[valid].all())
                     and bool(torch.equal(a_h[valid], addrs[valid])))
    return [int(hi.n_items(g.hash)), items, agree]


def _backend_eq(be, a, prefix):
    _group_eq(be.group, a, f"{prefix}/group" if f"{prefix}/group/alive" in a
              else prefix)
    _same(be.vals, a[f"{prefix}/vals"], f"{prefix} vals")
    _same(be.used, a[f"{prefix}/used"], f"{prefix} used")


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------
def test_hashes_match_jax_x64(jx):
    """key_mix over both words, sig_fp_of and bucket_of of int64 keys:
    the edges (0, 2**31, 2**32 + 1, 2**62, INT64_MAX - 1, ...), negative
    pads and 256 draws over the whole int64 range."""
    k = torch.as_tensor(J.hash_keys())
    assert k.dtype == I64
    h1, h2 = hs.key_mix(k)
    sig, fp = hs.sig_fp_of(k)
    b = hs.bucket_of(k, 1024)
    # the hashes are uint32 in JAX, held in int64 here: equal values
    for got, name in ((h1, "h1"), (h2, "h2")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jx.a[f"hash/{name}"]).astype(np.int64), err_msg=name)
    _same(sig, jx.a["hash/sig"], "sig")
    _same(fp, jx.a["hash/fp"], "fp")
    _same(b, jx.a["hash/bucket"], "bucket")
    d = hs.descriptors(k, 1024)
    for got, want in zip(d, (b, sig, fp)):
        assert torch.equal(got, want)
    assert hs.key_inf(I64) == 2 ** 63 - 1


# ---------------------------------------------------------------------------
# the routed ops on an int64 group
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["probe", "search", "range_query", "merge",
                                "backup_probe"])
def test_routed_op_matches_jax_x64(jx, op):
    """The op on JAX's int64 group (a pending window in both logs) at
    use_kernels="on", against JAX's ops there (its Pallas probe in
    interpret mode, jnp for the raw-key ops)."""
    a = jx.a
    g = convert.group_from_numpy(_jgroup(a, "ops/group"), "cpu")
    assert g.sorted[0].keys.dtype == I64 and g.blogs[0].keys.dtype == I64
    _group_eq(g, a, "ops/group")
    _, _, queries, bounds, (bk, ba, bo), sel = J.group_inputs()
    q = torch.as_tensor(queries)
    srt0 = g.sorted[0]
    if op == "probe":
        got = {"probe": ops.probe(CFG, g.hash, q)}
    elif op == "search":
        got = {"search": ops.search(CFG, srt0, q)}
    elif op == "merge":
        got = {"merge": ops.merge(CFG, srt0, torch.as_tensor(bk),
                                  torch.as_tensor(ba), torch.as_tensor(bo))}
    elif op == "backup_probe":
        got = {"backup_probe": ops.backup_probe(CFG, g.sorted, g.blogs, q,
                                                torch.as_tensor(sel))}
    else:
        got = {f"range_query/{i}": ops.range_query(CFG, srt0, lo, hi_, 64)
               for i, (lo, hi_) in enumerate(bounds)}
    for name, outs in got.items():
        for i, x in enumerate(outs):
            _same(x, a[f"ops/{name}/{i}"], f"{name} output {i}")


def test_wrappers_refuse_mixed_key_widths():
    """Queries, index keys and log keys share one dtype: a mix raises
    TypeError before anything is launched."""
    k32 = torch.zeros((4,), dtype=torch.int32)
    k64 = torch.zeros((4,), dtype=I64)
    a32 = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(TypeError, match="share one dtype"):
        ops.sorted_search_cuda(k32, k64, a32, 128)
    with pytest.raises(TypeError, match="share one dtype"):
        ops.merge_cuda(k64, a32, k32, a32,
                       torch.zeros((4,), dtype=torch.int8))
    srt = si.create(4, "cpu", I64)
    with pytest.raises(TypeError, match="share one dtype"):
        ops.backup_probe_cuda(k64, torch.zeros((4, 1), dtype=torch.int32),
                              (srt,), (lg.create(8, "cpu"),), 128)
    with pytest.raises(TypeError, match="share one dtype"):
        ops.hash_probe_cuda(k64.to(torch.int16), *hi.create(64, CFG, "cpu"),
                            4)
    with pytest.raises(ValueError, match="int32 or torch.int64"):
        LocalBackend(64, CFG, device="cpu", key_dtype=torch.int16)


# ---------------------------------------------------------------------------
# int64 queries on an int32 store: the store's width on every device
# ---------------------------------------------------------------------------
WIDTH_OPS = ("get", "get_degraded", "replica_probe", "owner_addr_probe",
             "put", "delete", "search", "merge", "backup_probe",
             "group_probe", "group_probe_stacked", "hash_probe")


def _int32_group(dev):
    """An int32 group over keys across the int32 range, negative ones
    included, with 601 entries pending in each backup log; and int64
    queries that hit it, miss it, and wrap onto its keys above 2**32."""
    rng = np.random.default_rng(32)
    keys = np.unique(np.concatenate([
        rng.integers(-2 ** 31, 2 ** 31 - 1, 3000),
        [-5, -1, 0, 7, 2 ** 31 - 2]])).astype(np.int32)
    rng.shuffle(keys)
    g = ig.create(1 << 13, CFG, dev)
    cuts = np.linspace(0, len(keys), 6).astype(int)
    for lo, hi_ in zip(cuts[:-1], cuts[1:]):
        g = ig.drain(g, CFG)
        g, ok = ig.put(g, torch.as_tensor(keys[lo:hi_], device=dev),
                       torch.arange(lo, hi_, dtype=torch.int32, device=dev),
                       CFG)
        assert bool(ok.all())
    q = np.concatenate([keys[:400], keys[-400:],
                        keys[:300].astype(np.int64) + (1 << 32),
                        rng.integers(-2 ** 40, 2 ** 40, 200),
                        [-5, -(1 << 40) + 7, 2 ** 62, J.INT64_MAX]])
    return g, torch.as_tensor(q.astype(np.int64), device=dev)


def _width_answers(g, q, op):
    """``op``'s answers on group ``g`` for queries ``q``, as a tuple of
    tensors."""
    dev = q.device
    Q, R = q.shape[0], len(g.sorted)
    sel = torch.as_tensor(np.random.default_rng(33).integers(
        0, 2, (Q, R)).astype(np.int32), device=dev)
    addrs = torch.arange(Q, dtype=torch.int32, device=dev)
    if op == "get":
        return ig.get(g, q, CFG)
    if op == "get_degraded":
        return ig.get(ig.fail(g, 0), q, CFG)
    if op == "replica_probe":
        return ig.replica_probe(g, q, CFG)
    if op == "owner_addr_probe":
        return ig.owner_addr_probe(g, q, CFG)
    if op in ("put", "delete"):
        g2, ok = (ig.put(g, q, addrs, CFG) if op == "put"
                  else ig.delete(g, q, CFG))
        return (ok, *g2.hash, *g2.blogs[0])
    if op == "search":
        return ops.search(CFG, g.sorted[0], q)
    if op == "merge":
        opc = torch.as_tensor(np.random.default_rng(34).choice(
            [1, 2], Q).astype(np.int8), device=dev)
        return tuple(ops.merge(CFG, g.sorted[0], q, addrs, opc))
    if op == "backup_probe":
        return ops.backup_probe(CFG, g.sorted, g.blogs, q, sel)
    if op == "group_probe":
        return ops.group_probe(CFG, g.hash, g.sorted, g.blogs, q, sel)
    if op == "group_probe_stacked":
        h = hi.HashIndex(*[a[None] for a in g.hash])
        return ops.group_probe_stacked(
            CFG, h, tree.stack([[s] for s in g.sorted]),
            tree.stack([[b] for b in g.blogs]), q[None])
    return ops.hash_probe(g.hash, q, CFG)


def _same_answers(got, want, what):
    assert len(got) == len(want), what
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.dtype == y.dtype, f"{what}: output {i} dtype"
        assert torch.equal(x.cpu(), y.cpu()), f"{what}: output {i} differs"


@pytest.mark.parametrize("op", WIDTH_OPS)
def test_int64_queries_take_an_int32_stores_width(op):
    """int64 queries on an int32 store answer as the same queries cast to
    int32 (as JAX's x32 mode takes them): the hash and the replicas see
    one key, so a GET that consults both, a degraded GET and a write
    agree with the store's own keys, negative ones included."""
    g, q = _int32_group("cpu")
    got = _width_answers(g, q, op)
    _same_answers(got, _width_answers(g, q.to(torch.int32), op), op)
    if op in ("get", "get_degraded", "replica_probe"):
        found = got[1]
        assert bool(found[:1100].all()) and not bool(found.all()), op


def test_group_probes_refuse_an_int64_store():
    """The group probes and the stacked SCAN have int32 kernels only: an
    int64 store raises TypeError on the CPU as on the card."""
    g = ig.create(256, CFG, "cpu", I64)
    q = torch.zeros((4,), dtype=I64)
    sel = torch.zeros((4, len(g.sorted)), dtype=torch.int32)
    bs = tree.stack([[s] for s in g.sorted])
    with pytest.raises(TypeError, match="int32 keys"):
        ops.group_probe(CFG, g.hash, g.sorted, g.blogs, q, sel)
    with pytest.raises(TypeError, match="int32 keys"):
        ops.group_probe_stacked(CFG, hi.HashIndex(*[a[None] for a in g.hash]),
                                bs, tree.stack([[b] for b in g.blogs]),
                                q[None])
    with pytest.raises(TypeError, match="int32 keys"):
        ops.range_query_stacked(CFG, bs, torch.zeros((1,), dtype=I64),
                                torch.ones((1,), dtype=I64), 4)


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mix,seed", J.TRACES)
def test_trace_matches_jax_x64(jx, mix, seed):
    """A gen_ops trace over [1, 2**62]: every answer, the final state,
    then a GET of the edge keys and a SCAN of the whole key space, each
    field and dtype JAX's (ScanResult.keys int64; addresses, counters
    and the count int32)."""
    from oracle import replay

    c = _client()
    assert c.backend.group.sorted[0].keys.dtype == I64
    assert _obs(replay(c, J.trace(mix, seed))) == jx.js[f"trace/{mix}"]
    _backend_eq(c.backend, jx.a, f"trace/{mix}")
    r = c.get(np.array(J.EDGE_KEYS, np.int64))
    for f in ("addrs", "found", "accesses", "values", "routed", "hops"):
        _same(getattr(r, f), jx.a[f"trace/{mix}/get/{f}"], f"GET {f}")
    s = c.scan(0, J.INT64_MAX - 1, 32)
    for f in ("keys", "addrs", "count"):
        _same(getattr(s, f), jx.a[f"trace/{mix}/scan/{f}"], f"SCAN {f}")


def test_failure_and_recovery_match_jax_x64(jx):
    """The primary dies (wiped), degraded GETs through the backup probe,
    the online rebuild; backup 0 dies and is re-cloned: the same answers,
    the same parity audit at every phase and the same final state."""
    from oracle import replay, splice_faults

    c = _client()
    phases = []
    obs = replay(c, splice_faults(J.trace(J.FAULT_MIX, J.FAULT_SEED),
                                  J.fault_schedule()),
                 phase_hook=lambda cl, ev: phases.append(
                     [list(ev), _parity(cl.backend.group, CFG)]))
    assert _obs(obs) == jx.js["faults"]
    assert _obs(phases) == jx.js["faults_parity"]
    _backend_eq(c.backend, jx.a, "faults")


def test_backend_carried_mid_failure_x64(jx):
    """A JAX x64 LocalBackend carried across with its primary dead
    (``backend_from_numpy`` takes the key dtype from the keys), then the
    rest of the trace, the rebuild and more reads, in both packages."""
    from oracle import replay

    a = jx.a
    be = convert.backend_from_numpy(
        _jgroup(a, "carry/at"), a["carry/at/vals"], a["carry/at/used"], CFG,
        "cpu", pending_bound=jx.js["carry_pending_bound"])
    assert be.key_dtype == I64 and not be._primary_alive
    _backend_eq(be, a, "carry/at")
    c = HiStoreClient(be, batch_quantum=J.QUANTUM)
    ops_ = J.trace("uniform", J.CARRY_SEED, J.CARRY_EVENTS)
    assert _obs(replay(c, ops_[J.CARRY_AT:])) == jx.js["carry"]
    c.recover_server(0)
    assert _obs(replay(c, ops_[:4])) == jx.js["carry_after"]
    _backend_eq(be, a, "carry/end")


# ---------------------------------------------------------------------------
# the serving engine's page directory
# ---------------------------------------------------------------------------
def test_serving_engine_int64_matches_jax_x64(jx):
    """Tiny musicgen-large's engine with key_dtype=torch.int64: the page
    bits and prefix modulus of JAX's x64 engine, every key it PUTs, every
    stats counter, each request's tokens, the free list and the
    directory's state equal to JAX's x64 engine on the same requests."""
    cfg = tiny_config(J.SERVE_ARCH)
    model = convert.params_from_numpy(jx.params, cfg, "cpu")
    e = eng.ServingEngine(cfg, model, device="cpu", key_dtype=I64,
                          **J.ENGINE)
    assert (e.page_bits, e.prefix_mod) == (20, 1 << 40)
    assert e.client.backend.key_dtype == I64
    put_keys = []
    stats1, tokens = J.drive_engine(e, put_keys)
    want = jx.js["serve"]
    assert stats1 == want["stats1"]
    assert e.stats == want["stats"]
    assert put_keys == want["put_keys"]
    assert max(put_keys) >= 2 ** 31        # the keys need the 64-bit space
    assert {str(k): v for k, v in tokens.items()} == want["tokens"]
    assert e.free_pages == want["free_pages"]
    _group_eq(e.directory, jx.a, "serve/group")
    _same(e.client.backend.vals, jx.a["serve/vals"], "serve vals")


# ---------------------------------------------------------------------------
# the int64 CUDA entry points on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels are CUDA "
                    "C++ built with nvcc and have no CPU mode")
    return torch.device("cuda")


def _wide_keys(rng, n):
    """n distinct int64 keys over [0, 2**63 - 1), the edges included."""
    k = np.unique(np.concatenate([
        np.array(J.EDGE_KEYS, np.int64),
        rng.integers(0, J.INT64_MAX - 1, n, dtype=np.int64),
        (rng.integers(0, 2 ** 31, n // 8, dtype=np.int64) << 32) | 3]))
    return k[rng.permutation(len(k))][:n]


def _launched(name, fn):
    n0 = ops.LAUNCHES[name]
    out = fn()
    assert ops.LAUNCHES[name] == n0 + 1, name
    return out


def _eq(got, want, what):
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.dtype == y.dtype, f"{what}: output {i} dtype"
        assert torch.equal(x, y), f"{what}: output {i} differs"


@pytest.mark.requires_cuda
def test_cuda_int64_entries_match_plain(cuda_device):
    """The int64 entries of the hash probe, the search, the SCAN's range
    and the merge against their plain versions on the card, each launch
    counted under its _i64 name."""
    dev = cuda_device
    rng = np.random.default_rng(64)
    keys = _wide_keys(rng, 60000)
    h, ok = hi.insert(hi.create(1 << 16, CFG, "cpu"),
                      torch.as_tensor(keys[:40000]),
                      torch.arange(40000, dtype=torch.int32), CFG)
    assert bool(ok.all())
    h = hi.HashIndex(*[x.to(dev) for x in h])
    s = si.bulk_load(si.create(1 << 16, dev, I64),
                     torch.as_tensor(keys[:40000], device=dev),
                     torch.arange(40000, dtype=torch.int32, device=dev))
    q = torch.as_tensor(np.concatenate([
        keys[:5000], keys[50000:53000], J.PAD_KEYS, J.EDGE_KEYS,
        rng.integers(-2 ** 63, J.INT64_MAX, 2000, dtype=np.int64)]),
        device=dev)
    _eq(_launched("hash_probe_i64", lambda: ops.probe(CFG, h, q)),
        hi.lookup(h, q, CFG), "probe")
    _eq(_launched("sorted_search_i64", lambda: ops.search(CFG, s, q)),
        si.search(s, q, CFG.fanout), "search")
    # the lower bound below key_inf (at key_inf it keeps the descent's
    # unclamped pos, as JAX's kernel does)
    below = q[q != J.INT64_MAX]
    for Q in (1, 200, below.shape[0]):
        got = ops.sorted_search_cuda(below[:Q].contiguous(), s.keys,
                                     s.addrs, CFG.fanout)
        assert torch.equal(got[4].long(),
                           torch.searchsorted(s.keys, below[:Q])), Q
    live = np.sort(keys[:40000])
    for lo, hi_ in [(0, J.INT64_MAX - 1), (int(live[9]), int(live[900])),
                    (int(live[-1]) + 1, J.INT64_MAX), (-(2 ** 63), 2 ** 40),
                    (J.INT64_MAX, J.INT64_MAX), (int(live[50]), 7)]:
        lo_t = torch.tensor(lo, dtype=I64, device=dev)
        hi_t = torch.tensor(hi_, dtype=I64, device=dev)
        for lim in (1, 128, 3000):
            _eq(_launched("sorted_search_i64", lambda: ops.range_query(
                CFG, s, lo_t, hi_t, lim)),
                si.range_query(s, lo_t, hi_t, lim), f"range {lo} {lim}")
    for m in (1, 300, 4096, 16384, 70000):
        bk = torch.as_tensor(rng.choice(keys, m), device=dev)
        ba = torch.as_tensor(rng.integers(0, 10 ** 5, m).astype(np.int32),
                             device=dev)
        bo = torch.as_tensor(rng.choice([0, 1, 2], m).astype(np.int8),
                             device=dev)
        _eq(_launched("merge_i64", lambda: tuple(ops.merge(CFG, s, bk, ba,
                                                           bo))),
            tuple(si.merge(s, bk, ba, bo)), f"merge m={m}")
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_int64_backup_probe_matches_plain(cuda_device):
    """The int64 backup probe against its plain version on the card:
    windows that wrap the ring and span several shared-memory tiles, logs
    holding keys that differ only in their high word, q = INT64_MAX (the
    reference's stale-slot quirk) and random replica selects."""
    dev = cuda_device
    rng = np.random.default_rng(65)
    keys = _wide_keys(rng, 30000)
    cases = ((1 << 14, [(1000, 1000 + (1 << 14) - 7), (30000, 40000)]),
             (64, [(10, 50), (0, 64)]), (5000, [(4000, 9000), (9, 9)]))
    for lcap, windows in cases:
        srts, logs = [], []
        for applied, tail in windows:
            s = si.bulk_load(si.create(1 << 15, dev, I64),
                             torch.as_tensor(keys[:20000], device=dev),
                             torch.arange(20000, dtype=torch.int32,
                                          device=dev))
            log = lg.create(lcap, dev, I64)
            n = lcap
            lk = rng.choice(keys[10000:], n)     # in and beyond the replica
            lk[: n // 4] ^= np.int64(1) << 40      # high-word neighbours
            log = log._replace(
                keys=torch.as_tensor(lk, device=dev),
                addrs=torch.as_tensor(rng.integers(0, 10 ** 5, n).astype(
                    np.int32), device=dev),
                ops=torch.as_tensor(rng.choice([1, 2], n).astype(np.int8),
                                    device=dev),
                applied=torch.tensor(applied, dtype=torch.int32, device=dev),
                tail=torch.tensor(tail, dtype=torch.int32, device=dev))
            srts.append(s)
            logs.append(log)
        q = torch.as_tensor(np.concatenate([
            rng.choice(keys[:30000], 6000), J.PAD_KEYS, J.EDGE_KEYS]),
            device=dev)
        sel = torch.as_tensor(rng.integers(0, 2, (q.shape[0], len(srts))
                                           ).astype(np.int32), device=dev)
        got = _launched("backup_probe_i64", lambda: ops.backup_probe(
            CFG, tuple(srts), tuple(logs), q, sel))
        _eq(got, ops.backup_probe_plain(CFG, tuple(srts), tuple(logs), q,
                                        sel), f"backup_probe lcap={lcap}")
    torch.cuda.synchronize()


def _drive(c, rng, keys):
    """A fixed round of the store's ops on client ``c`` (the draws from
    ``rng``): writes, reads that hit and miss, deletes, an apply and SCANs,
    the primary's failure with degraded reads and writes and its online
    rebuild, backup 0's failure and its re-clone.  Returns every answer as
    numpy arrays."""
    out = []

    def get(ks):
        r = c.get(ks)
        out.extend(_np(x) for x in (r.addrs, r.found, r.accesses, r.values))

    def scans():
        for _ in range(3):
            lo = int(rng.choice(keys))
            s = c.scan(lo, lo + int(rng.integers(1, 2 ** 60)), 64)
            out.extend(_np(x) for x in (s.keys, s.addrs, s.count))

    live = keys[:3000]
    out.append(_np(c.put(live, rng.integers(1, 2 ** 30, len(live))).ok))
    get(np.concatenate([live[:500], keys[3000:3500]]))
    out.append(_np(c.delete(live[:200]).found))
    c.apply()
    scans()
    for i, (event, server) in enumerate((("fail", 0), ("recover", 0),
                                         ("fail", 1), ("recover", 1))):
        getattr(c, event + "_server")(server)
        fresh = keys[3500 + 100 * i:3600 + 100 * i]
        out.append(_np(c.put(fresh, rng.integers(1, 2 ** 30, 100)).ok))
        out.append(_np(c.delete(live[200:260]).found))
        get(np.concatenate([live[:400], fresh, keys[-300:]]))
        scans()
        live = live[60:]
    return out


@pytest.mark.requires_cuda
def test_cuda_int64_store_runs_the_int64_kernels(cuda_device):
    """HiStoreClient(LocalBackend(key_dtype=torch.int64)) on the card
    answers as on the CPU through writes, reads, SCANs, a primary failure
    with its online rebuild and a backup failure with its re-clone, and
    launches the four int64 entries and no int32 one."""
    keys = _wide_keys(np.random.default_rng(66), 9000)
    want = _drive(_client(), np.random.default_rng(67), keys)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    c = HiStoreClient(LocalBackend(J.TRACE_CAP, CFG, device=cuda_device,
                                   key_dtype=I64), batch_quantum=J.QUANTUM)
    got = _drive(c, np.random.default_rng(67), keys)
    assert len(got) == len(want)
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.dtype == y.dtype, i
        np.testing.assert_array_equal(x, y, err_msg=str(i))
    for k in ("hash_probe", "sorted_search", "merge", "backup_probe"):
        assert ops.LAUNCHES[k + "_i64"] > 0 and ops.LAUNCHES[k] == 0, k


@pytest.mark.requires_cuda
def test_cuda_int64_queries_on_an_int32_store_match_the_cpu(cuda_device):
    """int64 queries on an int32 store on the card answer as on the CPU,
    through the int32 kernels, for every op of the CPU case above."""
    g_cpu, q_cpu = _int32_group("cpu")
    g, q = _int32_group(cuda_device)
    for op in WIDTH_OPS:
        _same_answers(_width_answers(g, q, op),
                      _width_answers(g_cpu, q_cpu, op), op)
    torch.cuda.synchronize()
