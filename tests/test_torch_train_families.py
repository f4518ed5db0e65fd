"""The port's training step held against the JAX package on the CPU for
the hybrid, MLA and MoE families at tiny sizes: zamba2-7b (Mamba-2 and
the weight-tied shared block, whose gradient sums over the layers that
call it), deepseek-v2-lite-16b (MLA, a leading dense layer, MoE with a
shared expert) and kimi-k2 (GQA with MoE): loss and aux, every gradient
leaf and three AdamW steps, with tests/_train_parity.py's tolerances.
"""
from __future__ import annotations

import pytest

from _train_parity import check_train_parity


@pytest.mark.parametrize("arch", ["zamba2-7b", "deepseek-v2-lite-16b",
                                  "kimi-k2-1t-a32b"])
def test_loss_grads_and_steps_match_jax(arch):
    check_train_parity(arch)
