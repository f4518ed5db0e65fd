"""The hybrid and MoE families on the card against the same weights on
the CPU: tiny zamba2 (Mamba-2 and the shared block), deepseek-v2-lite
(MLA and MoE) and kimi-k2 (GQA and MoE), float32 with TF32 off.  The
file imports no JAX, so that it runs where only PyTorch is installed;
tests/test_torch_ssm2.py and tests/test_torch_moe.py hold the CPU path
to the JAX package.  Tolerance 1e-4 (rtol and atol): cuBLAS and the CPU
sum in other orders.  The MoE's expert choice and drops are integer
work, equal on both devices unless two router probabilities sit within
an ulp, which the seeds here avoid (the chosen experts are compared
too)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs.tiny import tiny_config
from repro_torch.models import moe
from repro_torch.models import transformer as tr

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the model on the card "
                    "against the same model on the CPU")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["zamba2-7b", "deepseek-v2-lite-16b",
                                  "kimi-k2-1t-a32b"])
def test_cuda_family_matches_cpu(cuda_device, arch):
    """apply_model (hidden states and the aux loss), the first MoE
    layer's routing, then 12 decode steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_config(arch)
    cpu = tr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = tr.Model(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    tok = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 32)))
    h_c, aux_c = tr.apply_model(cfg, cpu, {"tokens": tok})
    h_g, aux_g = tr.apply_model(cfg, gpu, {"tokens": tok.to(cuda_device)})
    torch.testing.assert_close(h_g.cpu(), h_c, **TOL)
    torch.testing.assert_close(aux_g.cpu(), aux_c, **TOL)
    blocks = [i for i, b in enumerate(cpu.layers) if getattr(b, "moe", 0)]
    if blocks:
        x = torch.randn((64, cfg.d_model), generator=torch.Generator()
                        .manual_seed(1))
        e_c = moe.route(cfg, cpu.layers[blocks[0]].ffn, x)[2]
        e_g = moe.route(cfg, gpu.layers[blocks[0]].ffn, x.to(cuda_device))[2]
        assert torch.equal(e_g.cpu(), e_c)
    cc = tr.init_cache(cfg, 2, 16, device="cpu")
    cg = tr.init_cache(cfg, 2, 16, device=cuda_device)
    for t in range(12):
        inp = {"tokens": tok[:, t:t + 1], "pos": torch.full((2,), t)}
        lc, cc = tr.decode_step(cfg, cpu, cc, inp)
        lg, cg = tr.decode_step(cfg, gpu, cg, {
            k: v.to(cuda_device) for k, v in inp.items()})
        torch.testing.assert_close(lg.cpu(), lc, **TOL)
