"""Batched serving engine with a HiStore-backed page directory (port of
``repro/serving/engine.py``).

The decode cache is organised in pages; an *index group* (hash table +
sorted index + log), behind the port's ``HiStoreClient`` over
``LocalBackend``, is the page directory:

  * page registration (a page fills)  -> PUT (seq_id, page_no) -> page addr
    (synchronous hash update, logged, merged into the sorted index by the
    asynchronous apply: the paper's write path);
  * release of a sequence             -> SCAN over the key range
    [seq_id << PAGE_BITS, (seq_id + 1) << PAGE_BITS) on the sorted index,
    a GET of the pages' addresses and a DELETE: the range query the hash
    table cannot serve;
  * prefix reuse                      -> GET on hash(prompt tokens): a hit
    maps a new request onto existing pages.

Keys pack (seq_id, page_no) into an int32 key (``PAGE_BITS = 12`` and
``_PREFIX_MOD = 1 << 30``, the JAX package's values in x32 mode).  The
model decodes over per-slot caches while the directory tracks page
ownership.

Mirrored from the reference, not fixed: ``_admit`` gives a request a freed
slot without resetting that slot's cache, so a Mamba request admitted to
a reused slot starts from the previous request's conv and ssm state
(ROADMAP.md §C).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.histore import HiStoreConfig, scaled
from repro_torch.core.client import HiStoreClient, LocalBackend, _resolve_device
from repro_torch.models.transformer import decode_step, init_cache

PAGE_BITS = 12
_PREFIX_MOD = 1 << 30


def page_key(seq_id: int, page_no: int):
    return (int(seq_id) << PAGE_BITS) | int(page_no)


def prefix_key(prompt) -> int:
    return abs(hash(tuple(prompt))) % _PREFIX_MOD | (1 << (PAGE_BITS - 1))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    pos: int = 0
    done: bool = False
    prefix_hit: bool = False


class ServingEngine:
    """Greedy continuous-batching engine over decode_step.  The decode
    cache and the page directory live on ``device`` (the card unless the
    caller names another), where ``model`` must be too."""

    def __init__(self, cfg, model, *, batch_slots: int = 4,
                 max_len: int = 256, page_size: int = 16,
                 store_cfg: Optional[HiStoreConfig] = None, device=None):
        self.device = _resolve_device(device, "ServingEngine")
        self.cfg = cfg
        self.model = model
        self.B = batch_slots
        self.max_len = max_len
        self.page_size = page_size
        self.store_cfg = store_cfg or scaled(log_capacity=1 << 12,
                                             async_apply_batch=256)
        # page directory: the unified client over the serving node's index
        # group; values carry the page address, GETs/PUTs/SCANs are padded
        # to small fixed batches, async applies run every 64 mutations
        self.n_pages = batch_slots * (max_len // page_size) * 2
        self.client = HiStoreClient(
            LocalBackend(max(self.n_pages * 4, 1024), self.store_cfg,
                         device=self.device),
            batch_quantum=8, apply_every_n_ops=64)
        self.free_pages = list(range(self.n_pages, 0, -1))
        self.cache = init_cache(cfg, batch_slots, max_len,
                                device=self.device)
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.queue: list[Request] = []
        self._rid = 0
        self._step = functools.partial(decode_step, cfg)
        self.stats = {"index_puts": 0, "index_gets": 0, "index_scans": 0,
                      "prefix_hits": 0, "pages_registered": 0,
                      "pages_freed": 0, "decode_steps": 0}

    @property
    def directory(self):
        """The page-directory index group (introspection / tests)."""
        return self.client.backend.group

    # -- request lifecycle -------------------------------------------------
    def submit(self, prompt: list[int], max_new: int = 16) -> int:
        r = Request(self._rid, list(prompt), max_new)
        self._rid += 1
        # prefix reuse probe: GET on the prompt hash
        res = self.client.get([prefix_key(prompt)])
        self.stats["index_gets"] += 1
        if bool(res.found[0]):
            r.prefix_hit = True
            self.stats["prefix_hits"] += 1
        self.queue.append(r)
        return r.rid

    def _admit(self):
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                r = self.queue.pop(0)
                r.slot = i
                r.pos = 0
                r.tokens = []
                self.slots[i] = r
                # register the prompt-prefix key for future reuse
                self.client.put([prefix_key(r.prompt)], [r.slot])
                self.stats["index_puts"] += 1

    def _register_page(self, r: Request):
        page_no = (r.pos - 1) // self.page_size
        if not self.free_pages:
            return
        addr = self.free_pages.pop()
        self.client.put([page_key(r.rid, page_no)], [addr])
        self.stats["index_puts"] += 1
        self.stats["pages_registered"] += 1

    def release(self, r: Request):
        """Reclaim all of a sequence's pages via a sorted-index range scan
        (the SCAN the hash table cannot do).  The scan limit is one
        sequence's page budget and the scan repeats until the range
        drains, so long sequences cannot leak pages."""
        max_pages = max(self.max_len // self.page_size, 1)
        lo = page_key(r.rid, 0)
        hi = page_key(r.rid, max_pages - 1)
        while True:
            res = self.client.scan(lo, hi, max_pages)
            self.stats["index_scans"] += 1
            n = int(res.count)
            if n == 0:
                break
            keys = res.keys[:n]
            # the page address travels in the value payload
            vals = self.client.get(keys)
            freed = [int(a) for a in vals.values[:n, 0].cpu().tolist()]
            self.free_pages.extend(a for a in freed if a > 0)
            self.stats["pages_freed"] += n
            self.client.delete(keys)
            if n < max_pages:
                break

    # -- decode loop ---------------------------------------------------------
    def _batch_inputs(self):
        toks = np.zeros((self.B, 1), np.int32)
        pos = np.zeros((self.B,), np.int32)
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            if r.pos < len(r.prompt):
                toks[i, 0] = r.prompt[r.pos]
            elif r.tokens:
                toks[i, 0] = r.tokens[-1]
            pos[i] = r.pos
        return {"tokens": torch.as_tensor(toks, device=self.device),
                "pos": torch.as_tensor(pos, device=self.device)}

    def step(self):
        self._admit()
        if all(r is None for r in self.slots):
            return False
        logits, self.cache = self._step(self.model, self.cache,
                                        self._batch_inputs())
        self.stats["decode_steps"] += 1
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            r.pos += 1
            if r.pos % self.page_size == 0:
                self._register_page(r)
            if r.pos > len(r.prompt):
                r.tokens.append(int(nxt[i]))
            if (len(r.tokens) >= r.max_new
                    or r.pos >= self.max_len - 1):
                r.done = True
                self.release(r)
                self.slots[i] = None
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return steps
