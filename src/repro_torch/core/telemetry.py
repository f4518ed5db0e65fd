"""Ops telemetry plane: latency histograms, counters, gauges, op traces.

The paper's core claim is a latency decomposition (indexing is up to 74%
of op latency; §6 reports percentiles, not means), yet the repro could
only report mean wall-clock per figure script and had no visibility into
how often the degraded paths actually fire (retries, second-hop GETs,
lease demotions).  This module is the one low-overhead plane the whole
stack reports through:

  * ``LatencyHistogram`` — log2-bucketed (1 µs granularity floor) with a
    fixed numpy bucket array: ``record()`` is allocation-free on the hot
    path (one integer bit-length + three scalar updates), percentiles
    (p50/p95/p99/max) are extracted at snapshot time;
  * ``Telemetry`` — counters + per-op histograms + a bounded ring-buffer
    op-trace recorder, keyed on ``cfg.telemetry``:
        "off"       record/observe/span are no-ops; a snapshot taken
                    before equals one taken after any workload;
        "counters"  counters + latency histograms (the default);
        "trace"     counters + histograms + per-op spans
                    (route → dispatch → retries → detection events) in a
                    ring buffer dumpable to JSON for forensics;
  * ``MetricsSnapshot`` — the typed result of ``client.metrics()``, with
    ``render_text`` producing Prometheus text exposition format for
    ``client.metrics_text()``.

Gauges (pending-log depth, free-queue occupancy, live servers,
``fq_spill``) are NOT sampled on the hot path: backends surface them
lazily at snapshot time via ``telemetry_gauges()`` (one device fetch),
so enabling telemetry never adds a device sync to an op body.
"""
from __future__ import annotations

import json
import math
import threading
from typing import NamedTuple, Optional

import numpy as np

MODES = ("off", "counters", "trace")

# log2 buckets over microseconds: bucket 0 is < 1 µs, bucket i >= 1 is
# [2^(i-1), 2^i) µs; 48 buckets reach ~1.6e8 s — any op fits
N_BUCKETS = 48


class LatencySnapshot(NamedTuple):
    """Percentile summary of one op's latency histogram (seconds)."""
    count: int
    total: float
    mean: float
    p50: float
    p95: float
    p99: float
    max: float


class LatencyHistogram:
    """Log-bucketed latency histogram with an allocation-free record
    path: a preallocated int64 bucket array plus three scalars.  NOT
    thread-safe on its own — ``Telemetry`` serializes access."""

    __slots__ = ("buckets", "n", "total", "max")

    def __init__(self):
        self.buckets = np.zeros((N_BUCKETS,), np.int64)
        self.n = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        us = seconds * 1e6
        i = int(us).bit_length() if us >= 1.0 else 0
        if i >= N_BUCKETS:
            i = N_BUCKETS - 1
        self.buckets[i] += 1
        self.n += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds

    def percentile(self, q: float) -> float:
        """Upper bucket edge containing the q-quantile (conservative:
        never under-reports), clipped to the exact observed max."""
        if self.n == 0:
            return 0.0
        target = max(1, math.ceil(q * self.n))
        c = 0
        for i in range(N_BUCKETS):
            c += int(self.buckets[i])
            if c >= target:
                return min(2.0 ** i * 1e-6, self.max)
        return self.max

    def snapshot(self) -> LatencySnapshot:
        n = self.n
        return LatencySnapshot(
            count=n, total=self.total,
            mean=self.total / n if n else 0.0,
            p50=self.percentile(0.50), p95=self.percentile(0.95),
            p99=self.percentile(0.99), max=self.max)


class OpTrace:
    """Bounded ring buffer of op spans (plain dicts): the newest
    ``capacity`` spans survive, the oldest are overwritten — forensics
    memory stays O(capacity) no matter how long the client runs."""

    __slots__ = ("capacity", "_buf", "_next", "_n")

    def __init__(self, capacity: int = 256):
        self.capacity = max(int(capacity), 1)
        self._buf: list = [None] * self.capacity
        self._next = 0
        self._n = 0

    def record(self, span: dict) -> None:
        self._buf[self._next] = span
        self._next = (self._next + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)

    def spans(self) -> list:
        """Oldest-to-newest list of recorded spans."""
        if self._n < self.capacity:
            return [s for s in self._buf[:self._n]]
        return self._buf[self._next:] + self._buf[:self._next]

    def __len__(self) -> int:
        return self._n


class MetricsSnapshot(NamedTuple):
    """Typed result of ``client.metrics()``: a point-in-time copy —
    mutating the live telemetry after a snapshot never changes it."""
    mode: str
    counters: dict
    gauges: dict
    latency: dict          # op name -> LatencySnapshot
    trace_len: int

    def to_dict(self) -> dict:
        return {"mode": self.mode, "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "latency": {k: s._asdict() for k, s in
                            sorted(self.latency.items())},
                "trace_len": self.trace_len}


class Telemetry:
    """The per-backend metrics plane.  All mutators early-return in
    "off" mode before touching any state, so the off-mode hot path is a
    single attribute load + branch and a snapshot can never drift."""

    __slots__ = ("mode", "enabled", "tracing", "_lock", "_counters",
                 "_hists", "_trace")

    def __init__(self, mode: str = "counters",
                 trace_capacity: int = 256):
        if mode not in MODES:
            raise ValueError(
                f"cfg.telemetry must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.enabled = mode != "off"
        self.tracing = mode == "trace"
        self._lock = threading.Lock()   # ticker thread vs foreground
        self._counters: dict[str, int] = {}
        self._hists: dict[str, LatencyHistogram] = {}
        self._trace = OpTrace(trace_capacity) if self.tracing else None

    # -- hot-path mutators -------------------------------------------------
    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled or n == 0:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def observe(self, op: str, seconds: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            h = self._hists.get(op)
            if h is None:
                h = self._hists[op] = LatencyHistogram()
            h.record(seconds)

    def span(self, span: dict) -> None:
        """Record one op-trace span (trace mode only).  Spans are plain
        dicts; the client records {op, n, retries, seconds, events} and
        backends append detection events through the same ring."""
        if not self.tracing:
            return
        with self._lock:
            self._trace.record(span)

    # -- read side ---------------------------------------------------------
    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self, gauges: Optional[dict] = None) -> MetricsSnapshot:
        with self._lock:
            return MetricsSnapshot(
                mode=self.mode, counters=dict(self._counters),
                gauges=dict(gauges or {}),
                latency={k: h.snapshot() for k, h in self._hists.items()},
                trace_len=len(self._trace) if self._trace else 0)

    def trace_spans(self) -> list:
        with self._lock:
            return self._trace.spans() if self._trace else []

    def dump_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.trace_spans(), f, indent=2, default=str)


def render_text(snap: MetricsSnapshot) -> str:
    """Prometheus text exposition format for a snapshot: counters as
    ``histore_<name>_total``, gauges as ``histore_<name>``, latency
    histograms as one summary family with per-op labels."""
    lines = [f"# histore telemetry (mode={snap.mode})"]
    for name in sorted(snap.counters):
        lines.append(f"# TYPE histore_{name}_total counter")
        lines.append(f"histore_{name}_total {snap.counters[name]}")
    for name in sorted(snap.gauges):
        lines.append(f"# TYPE histore_{name} gauge")
        lines.append(f"histore_{name} {snap.gauges[name]}")
    if snap.latency:
        lines.append("# TYPE histore_op_latency_seconds summary")
        for op in sorted(snap.latency):
            s = snap.latency[op]
            for q, v in (("0.5", s.p50), ("0.95", s.p95),
                         ("0.99", s.p99)):
                lines.append(f'histore_op_latency_seconds'
                             f'{{op="{op}",quantile="{q}"}} {v:.9g}')
            lines.append(f'histore_op_latency_seconds_count'
                         f'{{op="{op}"}} {s.count}')
            lines.append(f'histore_op_latency_seconds_sum'
                         f'{{op="{op}"}} {s.total:.9g}')
    return "\n".join(lines) + "\n"


def dump_metrics(snap: MetricsSnapshot, path) -> None:
    """Write a snapshot as JSON — the batteries drop one into
    ``test-logs/`` so a hung or failed 8-device run ships its counter
    state with the CI failure artifacts."""
    with open(path, "w") as f:
        json.dump(snap.to_dict(), f, indent=2, default=str)
