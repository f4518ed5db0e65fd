"""Typed result objects of the HiStoreClient API, holding torch tensors
(port of ``repro/core/results.py``).

All tensor fields are trimmed to the caller's request length Q — the
client pads batches internally, and padding lanes never leak out.  They
are NamedTuples, so they unpack positionally like the raw tuples:
GetResult as (addrs, found, accesses, ...), ScanResult as (keys, addrs,
count).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PutResult(NamedTuple):
    ok: torch.Tensor       # bool [Q]: acknowledged (logged + indexed)
    addrs: torch.Tensor    # int32 [Q]: value address assigned by the store
    retries: int           # overflow-retry rounds this batch needed
    replicas: Optional[torch.Tensor] = None
    # int32 [Q]: replica logs that recorded the entry

    @property
    def all_ok(self) -> bool:
        return bool(self.ok.all())


class GetResult(NamedTuple):
    addrs: torch.Tensor     # int32 [Q]: value address (-1 on miss)
    found: torch.Tensor     # bool [Q]
    accesses: torch.Tensor  # int32 [Q]: index-side memory reads (Fig. 3)
    values: torch.Tensor    # int32 [Q, value_words]: payload (zeros on miss)
    routed: Optional[torch.Tensor] = None
    # bool [Q]: the request reached its server within max_retries; a
    # False lane is push-back, NOT an authoritative miss
    hops: Optional[torch.Tensor] = None
    # int32 [Q]: round-trips the value read took (1 on one node)

    @property
    def all_found(self) -> bool:
        return bool(self.found.all())

    @property
    def one_rtt(self) -> bool:
        """True when every found value was served without a second hop."""
        if self.hops is None:
            return True
        return bool((self.hops <= 1).all())


class DeleteResult(NamedTuple):
    ok: torch.Tensor       # bool [Q]: tombstone recorded
    found: torch.Tensor    # bool [Q]: key existed in the primary index
    retries: int
    replicas: Optional[torch.Tensor] = None   # as PutResult.replicas


class ScanResult(NamedTuple):
    keys: torch.Tensor     # [limit] ascending; key_inf-padded past ``count``
    addrs: torch.Tensor    # int32 [limit]
    count: torch.Tensor    # int32 scalar: live entries in [lo, hi]
    complete: Optional[bool] = None
    # False when some group had no live holder during the scan
    missing_groups: tuple = ()

    @property
    def is_complete(self) -> bool:
        """True unless the scan is KNOWN to have missed a group."""
        return self.complete is not False


class FailResult(NamedTuple):
    """Outcome of a fail/sever kill switch: the capability the backend
    actually exercised."""
    server: int
    wiped: bool           # False with a single group: every replica lives
    # on the failing server, so no surviving copy could exist and the
    # failure degrades to mask-only (state intact), with a warning


class RecoverResult(NamedTuple):
    """Outcome of a recovery: how it rebuilt and what else it repaired."""
    server: int
    online: bool          # snapshot-clone + streamed log catch-up (True)
    #                       vs stop-the-world drain-then-clone
    re_replicated: int    # replica copies the post-recovery
    #                       re-replication pass rebuilt
    catch_up_pending: int  # log entries still streaming into the rebuilt
    #                       replicas when recovery returned (0 for
    #                       offline recovery: the drain already ran)
