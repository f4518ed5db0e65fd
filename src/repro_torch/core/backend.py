"""The Backend protocol: the one typed contract between HiStoreClient
and a store implementation (port of ``repro/core/backend.py``).

Three member groups:

  * serving ops — fixed-shape batch ``put``/``get``/``delete``/``scan``
    plus the async-apply hooks (``apply_async``/``drain``) and the
    background value migration (``migrate_values``);
  * observability — ``telemetry_gauges`` and ``lease_stalled``;
  * fault injection / recovery — ``fail_*``, ``sever_*``, ``recover_*``
    (LocalBackend serves ``fail_server`` and ``recover_server``; its
    data-server and severing calls raise NotImplementedError, as the
    JAX LocalBackend's do; DistributedBackend serves them all).
"""
from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import torch


@runtime_checkable
class Backend(Protocol):
    """Fixed-shape batch ops over one store.  All mutating ops take a
    ``valid`` lane mask.  ``put`` returns (acked, addrs, replicas),
    ``delete`` (acked, found, replicas), ``get`` (addrs, found,
    accesses, vals, routed, hops) and ``scan`` (keys, addrs, count,
    covered)."""

    batch_multiple: int   # padded batch sizes must divide by this
    value_words: int      # payload width W of values [Q, W]

    # -- serving ops -------------------------------------------------------
    def put(self, keys, vals, valid) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]: ...
    def get(self, keys, valid) -> tuple: ...
    def delete(self, keys, valid) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]: ...
    def scan(self, lo, hi, limit: int) -> tuple: ...
    def apply_async(self) -> None: ...
    def drain(self) -> None: ...
    def migrate_values(self) -> int: ...

    # -- observability -----------------------------------------------------
    def telemetry_gauges(self) -> dict: ...
    def lease_stalled(self) -> bool: ...

    # -- fault injection / recovery ---------------------------------------
    def fail_server(self, server: int): ...
    def sever_server(self, server: int): ...
    def recover_server(self, server: int, **kw): ...
    def fail_data_server(self, server: int): ...
    def sever_data_server(self, server: int): ...
    def recover_data_server(self, server: int): ...
