"""The distributed store's protocol battery and the cluster example on the
port, held bit for bit against the JAX package on the CPU.

``tests/_dist_battery.py`` is ``src/repro/core/dist_selftest.py``'s
battery written once for both packages: the raw ops (routed PUT and GET
with payloads, misses, padding lanes, DELETE -> miss -> SCAN excludes,
degraded GET and PUT with index server 2 down, ``recover_server``,
``parity_report``), the client half with server 1 down and back, and
R = 3's scan duty.  A module-scoped subprocess forces 8 host devices,
builds the JAX mesh with ``AxisType.Auto`` axes (jax 0.9's default
Explicit axes make ``kv.create`` fail with a ShardingTypeError, as they
do the self-test and ``examples/histore_cluster.py`` as written), runs
the battery through the unmodified JAX ops and ``DistributedBackend``,
then runs the unmodified ``examples/histore_cluster.py`` on that kind of
mesh; it writes every op's outputs, the client answers and the final
store leaves to an ``.npz``.  The port runs the same battery through
``kv.make_ops`` and ``HiStoreClient(DistributedBackend(8, ...))``, and
``examples/histore_cluster_torch.py``: the battery's own checks hold,
every output and store leaf is bit-equal (dtype too), and the example
prints JAX's lines.  The module takes about 2 minutes, most of it the
JAX subprocess.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _dist_battery as battery
import _dist_ranks
from repro_torch.configs.histore import scaled
from repro_torch.core import kvstore as kv
from repro_torch.core import sorted_index as six
from repro_torch.core.client import DistributedBackend, HiStoreClient
from repro_torch.kernels import ops
from repro_torch.launch import ranks

ROOT = Path(__file__).resolve().parents[1]
G = 8

JAX_SIDE = r'''
import contextlib, importlib.util, io, json, sys, types
from pathlib import Path
import numpy as np
import jax
import jax.numpy as jnp
import _dist_battery as battery
from repro.configs.histore import scaled
from repro.core import kvstore as kv
from repro.core import sorted_index as six
from repro.core.hashing import key_dtype
import repro.core.client as jclient

G = 8
_make_mesh = jax.make_mesh


def make_mesh(shape, names, **kw):
    kw.setdefault("axis_types", (jax.sharding.AxisType.Auto,) * len(names))
    return _make_mesh(shape, names, **kw)


jax.make_mesh = make_mesh
mesh = jax.make_mesh((G,), (kv.AXIS,))
env = types.SimpleNamespace(
    G=G, scaled=scaled, kv=kv,
    create=lambda cap, cfg: kv.create(mesh, cap, cfg),
    make_ops=lambda cfg, capacity_q, scan_limit: kv.make_ops(
        mesh, cfg, capacity_q=capacity_q, scan_limit=scan_limit),
    make_client=lambda cfg, cap, capacity_q, scan_limit, **kw:
        jclient.HiStoreClient(jclient.DistributedBackend(
            mesh, cfg, cap, capacity_q=capacity_q, scan_limit=scan_limit),
            **kw),
    arr=jnp.asarray,
    own=lambda k: np.asarray(kv.owner_group(
        jnp.asarray(np.asarray(k), key_dtype()), G)),
    directory_levels=six.directory_levels,
    hash_fill=lambda st, g: np.asarray(st.hash.fill)[g])
out = {}
rec, stores = battery.run(env)
out.update({f"rec/{k}": v for k, v in rec.items()})
for name, st in stores.items():
    battery.leaves(st, name, out)

# the frozen cluster example, as written, on a mesh of Auto axes; its
# client recorded as it is built
clients = []


class Recorded(jclient.HiStoreClient):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        clients.append(self)


jclient.HiStoreClient = Recorded
spec = importlib.util.spec_from_file_location(
    "histore_cluster", Path(sys.argv[2]) / "examples" / "histore_cluster.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    mod.main()
out["cluster/stdout"] = np.array(buf.getvalue())
battery.leaves(clients[0].backend.store, "cluster", out)
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def jax8_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax8") / "battery.npz"
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path), str(ROOT)],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return path


@pytest.fixture(scope="module")
def jax8(jax8_npz):
    with np.load(jax8_npz) as z:
        return {k: z[k] for k in z.files}


def _port_env():
    def own(keys):
        k = torch.as_tensor(np.asarray(keys).astype(np.int32))
        return kv.owner_group(k, G).numpy()

    return types.SimpleNamespace(
        G=G, scaled=scaled, kv=kv,
        create=lambda cap, cfg: kv.create(G, cap, cfg, "cpu"),
        make_ops=lambda cfg, capacity_q, scan_limit: kv.make_ops(
            cfg, G, capacity_q, scan_limit),
        make_client=lambda cfg, cap, capacity_q, scan_limit, **kw:
            HiStoreClient(DistributedBackend(
                G, cfg, cap, capacity_q=capacity_q, scan_limit=scan_limit,
                device="cpu"), **kw),
        arr=torch.as_tensor, own=own,
        directory_levels=six.directory_levels,
        hash_fill=lambda st, g: st.hash.fill[g].numpy())


@pytest.fixture(scope="module")
def port():
    """The battery on the port: its own checks hold (it asserts them)."""
    rec, stores = battery.run(_port_env())
    out = {}
    for name, st in stores.items():
        battery.leaves(st, name, out)
    return rec, out


def _equal(got, want, label):
    assert got.dtype == want.dtype, (label, got.dtype, want.dtype)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=label)


def test_battery_ops_match_jax(jax8, port):
    """Every raw op's outputs, in order, bit-equal to JAX's."""
    rec, _ = port
    want = {k[4:]: v for k, v in jax8.items() if k.startswith("rec/")}
    assert sorted(rec) == sorted(want)
    raw = [k for k in rec if "/" in k and not k.startswith(("client",
                                                             "r3"))]
    assert len(raw) >= 40
    for k in raw:
        _equal(rec[k], want[k], k)


def test_battery_client_answers_match_jax(jax8, port):
    """The client half and R = 3's answers, the parity reports and the
    client's stats, equal to JAX's."""
    rec, _ = port
    for k in rec:
        if "/" not in k or k.startswith(("client", "r3")):
            assert json.loads(str(rec[k])) == json.loads(
                str(jax8[f"rec/{k}"])), k


@pytest.mark.parametrize("store", ["ops", "client", "r3"])
def test_battery_stores_match_jax(jax8, port, store):
    """The final store leaves of the raw ops and of both clients."""
    _, got = port
    keys = sorted(k for k in got if k.startswith(f"{store}/leaf/"))
    assert keys == sorted(k for k in jax8 if k.startswith(f"{store}/leaf/"))
    for k in keys:
        _equal(got[k], jax8[k], k)


def test_cluster_example_matches_jax(jax8):
    """examples/histore_cluster_torch.py prints the JAX example's lines and
    leaves the same store, bit for bit."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import histore_cluster_torch as ex
    finally:
        sys.path.remove(str(ROOT / "examples"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        client = ex.main(device="cpu")
    lines = buf.getvalue().splitlines()
    assert lines == str(jax8["cluster/stdout"]).splitlines()
    assert lines[-1] == "cluster example OK"
    got = {}
    battery.leaves(client.backend.store, "cluster", got)
    assert sorted(got) == sorted(k for k in jax8
                                 if k.startswith("cluster/leaf/"))
    for k, v in got.items():
        _equal(v, jax8[k], k)


def test_cluster_example_over_ranks_prints_jax_lines(jax8):
    """``examples/histore_cluster_torch.py --ranks 2`` on gloo ranks: rank
    0 prints the JAX example's lines, the other rank nothing."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "histore_cluster_torch.py"),
         "--ranks", "2", "--device", "cpu"], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.splitlines() == str(jax8["cluster/stdout"]).splitlines()


@pytest.mark.parametrize("world", [8, 4])
def test_battery_over_ranks_matches_jax(jax8_npz, world):
    """The battery over ``world`` gloo ranks on the CPU (8: JAX's one group
    a device; 4: two groups a rank), each rank a process: on every rank
    every op output, client answer and gathered store leaf is bit-equal
    to JAX's, dtype included (``_dist_ranks.battery_vs_jax``)."""
    counts = ranks.spawn(_dist_ranks.battery_vs_jax, world, device="cpu",
                         timeout_s=600, args=(str(jax8_npz),))
    assert len(counts) == world and len(set(counts)) == 1
    assert counts[0] > 100


@pytest.mark.requires_cuda
def test_cuda_group_probe_at_g0_matches_plain():
    """group_probe.cu on a rank's stack (servers g0 .. g0 + L - 1 of the
    store's 8, the global G and g0 passed) equals its plain version, on a
    degraded store whose lanes reach the hash, replica and log paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels are CUDA "
                    "C++ built with nvcc and have no CPU mode")
    cfg, st, rk = _dist_ranks.probe_case("cuda")
    for g0, L in ((0, 8), (1, 1), (2, 2), (4, 4), (3, 5)):
        args = (*_dist_ranks.rows_of(st, g0, L), rk[g0:g0 + L], G, g0)
        n0 = ops.LAUNCHES["group_probe"]
        got = ops.group_probe_stacked(cfg, *args)
        assert ops.LAUNCHES["group_probe"] == n0 + 1
        want = ops.group_probe_stacked_plain(cfg, *args)
        for i, (x, y) in enumerate(zip(got, want)):
            assert x.dtype == y.dtype, (g0, L, i)
            assert torch.equal(x, y), (g0, L, i)
