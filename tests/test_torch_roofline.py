"""The port's tools layer held against the JAX package's: ``input_specs``,
the roofline's ``active_params`` / ``model_flops`` / ``roofline_terms``,
the partition rules as a layout planner, the compositional cost on the
meta device and one dry-run cell.

The JAX side is ``jax.eval_shape`` over JAX's ``init_params`` and
``init_cache`` (no allocation), its specs taken on a device-less fake
mesh as ``tests/test_roofline_and_sharding.py`` does; the port's side is
the same config on the meta device.  Counts, specs and shapes are held
exactly.  The compositional cost is held against one counted run of the
whole tiny model: FLOPs exactly, bytes exactly up to the global grad
norm's pass over the layer parameters, which the composition leaves to
the base program (as the JAX package's does); the test counts that pass
and adds it.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import init_params as jinit_params
from repro.roofline.analysis import active_params as jactive_params
from repro.roofline.analysis import model_flops as jmodel_flops
from repro.sharding import partition as jpart
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.tiny import tiny_config
from repro_torch.convert import param_tree, stack_like, stage_layout
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (local_mesh, n_devices, parse_mesh,
                                     production_mesh)
from repro_torch.models.transformer import init_cache
from repro_torch.optim.adamw import global_norm
from repro_torch.pytree import leaves, leaves_with_path
from repro_torch.roofline import compositional as comp
from repro_torch.roofline.analysis import (HW, active_params, model_flops,
                                           roofline_terms)
from repro_torch.sharding import partition as part

MESHES = {"16x16": production_mesh(),
          "2x16x16": production_mesh(multi_pod=True)}
DECODE = ("decode_32k", "long_500k")
FAMILIES = {"dense": "mistral-nemo-12b", "local-global": "gemma3-27b",
            "mla-moe": "deepseek-v2-lite-16b", "mamba1": "falcon-mamba-7b",
            "mamba2-shared": "zamba2-7b"}
TINY = {"train": ShapeSpec("tiny_train", 16, 2, "train"),
        "prefill": ShapeSpec("tiny_prefill", 16, 2, "prefill"),
        "decode": ShapeSpec("tiny_decode", 16, 2, "decode")}


class FakeMesh:
    """What JAX's partition rules read of a mesh, with no devices."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


_TREES: dict = {}        # arch, or (arch, decode shape) -> its trees


def trees(arch):
    """(JAX's params tree of ShapeDtypeStructs, the port's stacked meta
    params), built once an arch."""
    if arch not in _TREES:
        jcfg, cfg = jget_config(arch), get_config(arch)
        jp = jax.eval_shape(lambda k: jinit_params(jcfg, k),
                            jax.random.PRNGKey(0))
        tp = stack_like(param_tree(comp.meta_model(cfg), cfg))
        _TREES[arch] = (jp, tp)
    return _TREES[arch]


def caches(arch, name):
    """(JAX's decode cache of ShapeDtypeStructs, the port's in JAX's
    layout on the meta device) of a decode shape, built once."""
    key = (arch, name)
    if key not in _TREES:
        jcfg, cfg = jget_config(arch), get_config(arch)
        B, S = SHAPES[name].global_batch, SHAPES[name].seq_len
        jc = jax.eval_shape(lambda: jinit_cache(jcfg, B, S))
        tc = stack_like(stage_layout(init_cache(cfg, B, S, device="meta"),
                                     cfg))
        _TREES[key] = (jc, tc)
    return _TREES[key]


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


def _jax_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree, specs):
    return [part.spec_at(specs, p) for p, _ in leaves_with_path(tree)]


def _assert_same_leaves(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), leaves(ttree)
    assert [(tuple(x.shape), _dtype(x)) for x in jl] == \
        [(tuple(x.shape), _dtype(x)) for x in tl]


# ---------------------------------------------------------------------------
# input_specs, the roofline's counts and terms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    for name in SHAPES:
        j = jinput_specs(jget_config(arch), JSHAPES[name])
        t = input_specs(get_config(arch), SHAPES[name])
        assert sorted(j) == sorted(t), name
        for k in j:
            assert t[k].device.type == "meta"
            assert tuple(t[k].shape) == tuple(j[k].shape), (name, k)
            assert _dtype(t[k]) == _dtype(j[k]), (name, k)


def test_shapes_and_applicability_match_jax():
    from repro.configs import shape_applicable as japplicable
    from repro_torch.configs import shape_applicable

    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JSHAPES.items()}
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                japplicable(jget_config(arch), JSHAPES[name])


def test_roofline_terms_dominance():
    """JAX's test_roofline_terms_dominance with the H100's figures."""
    assert (HW.peak_flops, HW.hbm_bw, HW.link_bw) == (989.4e12, 3.35e12,
                                                       450e9)
    t = roofline_terms(HW.peak_flops * 2.0, HW.hbm_bw * 0.5, HW.link_bw)
    assert t["dominant"] == "compute_s"
    assert abs(t["compute_s"] - 2.0) < 1e-9
    assert abs(t["roofline_fraction_compute"] - 1.0) < 1e-9
    t = roofline_terms(HW.peak_flops, HW.hbm_bw * 10, 0)
    assert t["dominant"] == "memory_s"
    assert t["collective_s"] == 0.0
    assert abs(t["roofline_fraction_compute"] - 0.1) < 1e-12


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_match_jax(arch, kind):
    jp, tp = trees(arch)
    jcfg, cfg = jget_config(arch), get_config(arch)
    counts = jactive_params(jcfg, jp)
    assert active_params(cfg, tp) == counts
    assert model_flops(cfg, *counts, SHAPES[kind]) == \
        jmodel_flops(jcfg, *counts, JSHAPES[kind])


# ---------------------------------------------------------------------------
# The partition rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_specs_match_jax(arch, mesh):
    """Every leaf's param, opt, input and cache spec equals JAX's, with
    fsdp and the decode cache hint off and on."""
    jp, tp = trees(arch)
    _assert_same_leaves(jp, tp)
    m, fm = MESHES[mesh], FakeMesh(MESHES[mesh])
    for extra in ({}, {"fsdp": True, "decode_cache_hint": True}):
        jcfg = jget_config(arch).scaled(**extra)
        cfg = get_config(arch).scaled(**extra)
        assert _port_specs(tp, part.param_pspecs(cfg, tp, m)) == \
            _jax_specs(jpart.param_pspecs(jcfg, jp, fm))
        assert _port_specs(tp, part.opt_pspecs(cfg, tp, m)) == \
            _jax_specs(jpart.opt_pspecs(jcfg, jp, fm))
        for name in SHAPES:
            ti = input_specs(cfg, SHAPES[name])
            assert _port_specs(ti, part.input_pspecs(
                cfg, SHAPES[name], ti, m)) == _jax_specs(jpart.input_pspecs(
                    jcfg, JSHAPES[name], jinput_specs(jcfg, JSHAPES[name]),
                    fm))
        for name in DECODE:
            jc, tc = caches(arch, name)
            _assert_same_leaves(jc, tc)
            assert _port_specs(tc, part.cache_pspecs(
                cfg, SHAPES[name], tc, m)) == _jax_specs(jpart.cache_pspecs(
                    jcfg, JSHAPES[name], jc, fm))


def test_per_device_bytes_and_meshes():
    tree = {"a": torch.empty((32, 48), dtype=torch.bfloat16, device="meta"),
            "b": [torch.empty((4, 16), device="meta")]}
    m = {"data": 16, "model": 16}
    specs = {"a": ("data", "model"), "b": [(None, "model")]}
    assert part.per_device_bytes(tree, specs, m) == \
        32 * 48 * 2 // 256 + 4 * 16 * 4 // 16
    assert part.per_device_bytes(tree, {"a": (None, None),
                                        "b": [(None, None)]}, m) == \
        32 * 48 * 2 + 4 * 16 * 4
    assert parse_mesh("1") == local_mesh() == {"data": 1, "model": 1}
    assert parse_mesh("16x16") == production_mesh()
    assert parse_mesh("2x16x16") == production_mesh(multi_pod=True)
    assert n_devices(production_mesh(multi_pod=True)) == 512


# ---------------------------------------------------------------------------
# The compositional cost against the whole model
# ---------------------------------------------------------------------------
def _grad_norm_bytes(cfg) -> float:
    grads = [torch.empty_like(p)
             for p in leaves(param_tree(comp.meta_model(cfg), cfg))]
    return comp.count(global_norm, grads)["bytes_unfused"]


@pytest.mark.parametrize("kind", list(TINY))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_compositional_equals_whole_model(family, kind):
    cfg = tiny_config(FAMILIES[family])
    shape = TINY[kind]
    got = comp.compositional_cost(cfg, shape)
    want = comp.count(comp.whole_step(cfg, shape))
    assert got["flops"] == want["flops"] > 0
    gap = 0.0
    if kind == "train":
        # the global grad norm over the layer parameters: the whole
        # step's norm pass less the base program's
        gap = _grad_norm_bytes(cfg) - _grad_norm_bytes(cfg.scaled(
            n_layers=0, first_k_dense=0, shared_attn_every=0))
        assert gap > 0
    assert got["bytes_unfused"] + gap == want["bytes_unfused"]
    assert got["flops_source"] == "gemm"
    assert sum(v["count"] for k, v in got["per_layer"].items()
               if k not in ("base", "shared")) == cfg.n_layers


def test_dryrun_one_cell():
    rec = dryrun.dry_cell("musicgen-large", "train_4k", local_mesh())
    assert rec["status"] == "ok"
    assert rec["params_total"] == 3229812736
    assert rec["model_flops_global"] == 6.0 * 3229812736 * 256 * 4096
    assert rec["flops"] > 0 and rec["bytes_unfused"] > 0
    state = rec["state_bytes_per_device"]
    weights = sum(p.numel() * p.element_size()
                  for p in leaves(trees("musicgen-large")[1]))
    assert state["grads"] == state["weights"] == weights
    assert state["adam_m"] == state["adam_v"] == 4 * 3229812736
    assert state["total"] == sum(v for k, v in state.items()
                                 if k != "total")
    r = rec["roofline"]
    assert r["compute_s"] == rec["flops"] / HW.peak_flops
    assert r["collective_s"] == 0.0
    skipped = dryrun.dry_cell("musicgen-large", "long_500k", local_mesh())
    assert skipped["status"] == "skipped"
