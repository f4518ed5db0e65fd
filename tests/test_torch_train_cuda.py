"""The training step on the card against the same weights and batches on
the CPU: tiny configs of every family, float32 with TF32 off, two AdamW
steps.  The file imports no JAX, so that it runs where only PyTorch is
installed; tests/test_torch_train.py and tests/test_torch_train_families.py
hold the CPU path to the JAX package.  Last, the MoE over 2 gloo ranks
on CUDA tensors against one process on the card (the rank body is
tests/_train_ranks.py's, which imports no JAX either).

Tolerances: the loss and grad norm within 1e-4 (relative; cuBLAS and the
CPU sum in other orders), every parameter within 2 * lr * steps and all
but 0.1% within 1e-5 (tests/_train_parity.py: AdamW steps an element
whose gradient is float32 noise by about lr in either direction).
"""
from __future__ import annotations

import copy

import pytest
import torch

from repro_torch.configs.tiny import tiny_config
from repro_torch.convert import param_tree, stack_tree
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.models import transformer as tr
from repro_torch.optim.adamw import adamw_init
from repro_torch.pytree import leaves
from repro_torch.train.step import train_step

LR, STEPS = 3e-3, 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the train step on the "
                    "card against the same step on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["musicgen-large", "gemma3-27b",
                                  "internvl2-76b", "falcon-mamba-7b",
                                  "zamba2-7b", "deepseek-v2-lite-16b",
                                  "kimi-k2-1t-a32b"])
def test_cuda_train_step_matches_cpu(cuda_device, arch):
    cfg = tiny_config(arch)
    cpu = tr.Model(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda_device)
    ds = SyntheticLM(cfg.vocab_size, 32, 2, seed=1,
                     embed_dim=cfg.d_model if cfg.frontend == "embed" else 0)
    opts = [adamw_init(param_tree(m, cfg)) for m in (cpu, gpu)]
    for step in range(STEPS):
        out = [train_step(cfg, m, o, make_batch(ds, step, device=d), lr=LR)
               for m, o, d in ((cpu, opts[0], "cpu"),
                               (gpu, opts[1], cuda_device))]
        for k in ("loss", "grad_norm"):
            a, b = float(out[0][2][k]), float(out[1][2][k])
            assert abs(a - b) <= 1e-4 * abs(a), (step, k, a, b)
    d = torch.cat([(x.float() - y.float().cpu()).abs().ravel() for x, y in
                   zip(leaves(stack_tree(param_tree(cpu, cfg))),
                       leaves(stack_tree(param_tree(gpu, cfg))))])
    assert float(d.max()) <= 2 * LR * STEPS
    assert float((d > 1e-5).float().mean()) <= 1e-3


@pytest.mark.requires_cuda
def test_moe_over_gloo_ranks_on_the_card(tmp_path):
    """The MoE at DROP_CF over 2 gloo ranks on CUDA tensors against one
    process on the card: the global capacity and slot ranks hold in the
    backward's recompute too.  Float32 with TF32 off; the loss and grad
    norm within 1e-4 relative (cuBLAS sums in other orders at other batch
    sizes, as above)."""
    import _train_ranks as R
    from repro_torch.launch import ranks

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the MoE over gloo "
                    "ranks on CUDA tensors")
    torch.backends.cuda.matmul.allow_tf32 = False
    R.init_checkpoint(R.MOE_ARCH, tmp_path / "init")
    a = R.copy_dir(tmp_path / "init", tmp_path / "ranks")
    b = R.copy_dir(tmp_path / "init", tmp_path / "one")
    got = ranks.spawn(R.moe_on_card, 2, device="cuda", backend="gloo",
                      timeout_s=300, args=(str(a),))
    want = R.run(R.cfg_of(R.MOE_ARCH, capacity_factor=R.DROP_CF), b,
                 device="cuda")
    assert got[0]["loss"] == got[1]["loss"]
    assert got[0]["step"] == want["step"]
    for k in ("loss", "grad_norm"):
        for x, y in zip(got[0][k], want[k]):
            assert abs(x - y) <= 1e-4 * abs(y), (k, got[0][k], want[k])
