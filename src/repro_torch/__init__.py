"""HiStore in PyTorch for an NVIDIA H100: the port of ``src/repro``.

The single-node store: ``HiStoreClient`` over ``LocalBackend``
(PUT/GET/DELETE/SCAN, the asynchronous log->sorted apply, failure and
recovery), and the healthy distributed store over G index groups on one
device (``DistributedBackend``).  The serving path of every model
family of ``configs`` (Mamba-1, the dense GQA family, zamba2's Mamba-2
with its shared block, MLA and MoE): ``models`` (``Model`` with its
blocks), ``serving.serve_step.prefill`` and
``serving.engine.ServingEngine``, whose page directory is a
``HiStoreClient``.  Training of every family: ``train.trainer.train``
over ``train.step.train_step``, ``optim`` (the JAX package's AdamW and
int8 compression), ``data`` (the synthetic stream) and ``checkpoint``
(the JAX package's file format, so either package resumes the other's
run).  The index hot path and the Mamba-1 scan run through
hand-written CUDA kernels (``kernels/csrc``) for tensors on the card and
through plain PyTorch for tensors on the CPU; ``repro_torch.kernels`` is
the whole dispatch surface of ``repro.kernels``, its legacy wrappers
and oracles included.

    from repro_torch.core.client import HiStoreClient, LocalBackend
    client = HiStoreClient(LocalBackend(1 << 20, DEFAULT))     # on cuda

Keys are int32 (``key_inf`` = 2**31 - 1 is reserved).  This package
imports torch and numpy only.
"""
