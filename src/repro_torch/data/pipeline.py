"""Deterministic, stateless data pipeline (port of
``repro/data/pipeline.py``).

Batches are a pure function of (seed, step), with no iterator state, so
a restart is exactly-once: after restoring a checkpoint at step k, batch
k is the one the crashed run would have drawn.  ``SyntheticLM`` is a
numpy copy of the JAX package's stream and gives its arrays bit for bit;
``make_batch`` puts a batch on the device (the card unless the caller
names another).  Over ranks (``train/dp.py``) each rank draws the global
batch on the host, as the JAX package's ``make_batch`` does, and keeps
its rows (``rows=dp.rows(global_batch)``, JAX's per-shard placement),
or at a global batch of 1 its block of the sequence (``seq``, the
second of ``dp.split``): a batch is the same whatever the number of
ranks, which keeps an elastic resume exact.

The synthetic LM stream is a Zipf-ish token mixture with a short-range
copy structure, so tiny models show a real, monotonically improving loss.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.client import _resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embed_dim: int = 0          # >0 -> embed-frontend stub (vlm/audio)

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        base = rng.zipf(1.5, size=(B, S)).astype(np.int64) % max(V - 2, 1)
        # short-range copy structure: token[t] sometimes repeats token[t-3]
        mask = rng.random((B, S)) < 0.35
        out = base.copy()
        out[:, 3:][mask[:, 3:]] = base[:, :-3][mask[:, 3:]]
        return out.astype(np.int32)

    def batch(self, step: int) -> dict:
        toks = self._tokens(step)
        tgt = np.concatenate([toks[:, 1:], np.full((toks.shape[0], 1), -1,
                                                   np.int32)], axis=1)
        if self.embed_dim:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed + 7, step]))
            emb = rng.standard_normal(
                (self.global_batch, self.seq_len, self.embed_dim),
                dtype=np.float32)
            return {"embeds": emb, "targets": tgt}
        return {"tokens": toks, "targets": tgt}


def make_batch(ds: SyntheticLM, step: int, *, device=None,
               dtype=None, rows=None, seq=None) -> dict:
    """Host batch -> tensors on ``device``; with ``dtype`` the embeds are
    cast to it (round to nearest even, as numpy's cast to bfloat16 in the
    JAX package); with ``rows`` (a slice) only those rows of the global
    batch, and with ``seq`` (a slice) only those positions of each."""
    dev = _resolve_device(device, "make_batch")
    host = ds.batch(step)
    if rows is not None or seq is not None:
        at = (slice(None) if rows is None else rows,
              slice(None) if seq is None else seq)
        host = {k: np.ascontiguousarray(v[at]) for k, v in host.items()}
    out = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    if dtype is not None and "embeds" in out:
        out["embeds"] = out["embeds"].to(dtype)
    return out
