"""Serving: prefill and decode steps, and the batched engine with its
HiStore page directory (port of ``repro/serving``)."""
