"""HiStore (the paper's own system) deployment configuration.

The same knobs, defaults and validation as the JAX package's
``configs/histore.py``, so two configs compare field for field.  Key
16 B in the paper; here int32 keys plus a 63-bit signature pair.  Value
32 B, chained hash buckets of 8 slots x 4 sub-buckets, the skiplist
becomes a 128-fanout hierarchical sorted directory.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class HiStoreConfig:
    # hash index ---------------------------------------------------------
    slots_per_bucket: int = 8      # paper: 7 slots + next ptr in a 64B bucket;
                                   # we pre-link chains so all 8 are key slots
    max_chain: int = 4             # pre-linked chain length (paper: dynamic)
    load_factor: float = 0.5       # buckets over-provisioned to avoid resizing
    # sorted index (skiplist -> hierarchical directory) -------------------
    fanout: int = 128              # one "express lane" hop searches a
                                   # 128-wide node (4 keys per warp lane)
    # index group ---------------------------------------------------------
    n_backups: int = 2             # replicas of the sorted index (paper §3.3)
    log_capacity: int = 1 << 16    # per-group append-only log entries
    # value store ----------------------------------------------------------
    value_words: int = 4           # 32 B values = 4 x int64 words
    n_value_replicas: int = 1      # mirror copies of each data shard
    # distribution ---------------------------------------------------------
    groups_per_device: int = 1
    # failure detection ----------------------------------------------------
    lease_misses: int = 3          # 0 disables detection entirely
    lease_clock: str = "wall"      # "wall" | "rounds"
    lease_timeout_s: float = 1.0
    lease_interval_s: float = 0.25
    # telemetry ------------------------------------------------------------
    telemetry: str = "counters"    # "off" | "counters" | "trace"
                                   # (core/telemetry.py)
    # batching -------------------------------------------------------------
    async_apply_batch: int = 4096  # log entries merged into the sorted index
                                   # per asynchronous apply
    # kernel dispatch -------------------------------------------------------
    use_kernels: str = "auto"      # the route follows the tensor's device
                                   # (kernels/ops.py): a CUDA tensor always
                                   # launches the CUDA kernel, a CPU tensor
                                   # takes the plain PyTorch version.
                                   # "on"/"auto" allow that; "off" makes a
                                   # CUDA tensor raise, never silently
                                   # route the card to the plain path

    def __post_init__(self):
        if self.use_kernels not in ("off", "on", "auto"):
            raise ValueError(
                f"use_kernels must be 'off', 'on' or 'auto', "
                f"got {self.use_kernels!r}")


DEFAULT = HiStoreConfig()


def scaled(**kw) -> HiStoreConfig:
    return dataclasses.replace(DEFAULT, **kw)
