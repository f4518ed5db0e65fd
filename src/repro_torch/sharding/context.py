"""The data-parallel group the model's collectives read while a loss and
its gradient are taken (the port's counterpart of the JAX package's
``sharding/context.use_mesh``).

    with use_dp(dp):        # train/step.py's value_and_grad
        ...                 # models/moe.py: current_dp() is dp

The group sits in one slot of the process, not in a ``ContextVar``: on
the card, autograd runs the backward, and so the forward that
``remat="unit"`` recomputes there, on a thread of its own, which does
not see the caller's context variables.  A process takes one training
step at a time, so one slot is enough.  The slot is below both the
models and the trainer, which import it.
"""
from __future__ import annotations

import contextlib

_DP = None


@contextlib.contextmanager
def use_dp(dp):
    """Make ``dp`` the group ``current_dp`` answers, on every thread,
    inside the block."""
    global _DP
    prev, _DP = _DP, dp
    try:
        yield dp
    finally:
        _DP = prev


def current_dp():
    """The group set by ``use_dp``, or None."""
    return _DP
