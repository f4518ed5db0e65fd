"""Checkpoints in the JAX package's file format (port of
``repro/checkpoint/checkpoint.py``).

One ``step_{step:08d}.npz`` per checkpoint step (flat leaf path ->
array; a path is the tree's dict keys and sequence indices joined by
"/", in the JAX package's tree order), ``manifest_{step:08d}.json`` and
``manifest.json`` ({step, keys, dtypes}).  A bf16 leaf is stored as its
bits, a ``uint16`` array, with "bfloat16" in the manifest; numpy has no
bfloat16 here (the JAX package reads it through ``ml_dtypes``), so the
bits go through torch's int16 view both ways.  A checkpoint either
package writes restores in the other.  Saves are atomic (tmp + rename),
so a crash mid-save never corrupts the latest checkpoint;
``AsyncCheckpointer`` copies the tree to host memory, then writes it on a
background thread.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.client import _resolve_device
from repro_torch.pytree import leaves_with_path, path_key, tree_map, unflatten

BF16 = "bfloat16"


def _dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype ("float32", "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array the file holds: a bf16 tensor's bits as
    uint16."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype.name == BF16 else a


def save_checkpoint(ckpt_dir, step: int, tree) -> Path:
    """Write ``tree`` (tensors on any device, or numpy arrays) as step
    ``step``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = {path_key(p): v for p, v in leaves_with_path(tree)}
    dtypes = {k: _dtype_name(v.dtype) for k, v in flat.items()}
    packed = {k: _to_numpy(v) for k, v in flat.items()}
    tmp = ckpt_dir / f".tmp_step_{step}.npz"
    final = ckpt_dir / f"step_{step:08d}.npz"
    np.savez(tmp, **packed)
    tmp.rename(final)
    manifest = {"step": step, "keys": sorted(flat), "dtypes": dtypes}
    (ckpt_dir / f"manifest_{step:08d}.json").write_text(json.dumps(manifest))
    (ckpt_dir / "manifest.json").write_text(json.dumps(manifest))
    return final


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.stem.split("_")[1]) for p in
                   ckpt_dir.glob("step_*.npz"))
    return steps[-1] if steps else None


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, _dtype_name(dtype))


def read_leaves(ckpt_dir, step: int, like_tree):
    """Step ``step``'s leaves of ``like_tree``'s structure (leaves with
    ``.shape`` and ``.dtype``, torch's or numpy's) one at a time, in tree
    order, as CPU tensors, each cast to its ``like`` leaf's dtype where
    the file's differs: the file is read a leaf at a time."""
    ckpt_dir = Path(ckpt_dir)
    data = np.load(ckpt_dir / f"step_{step:08d}.npz")
    manifest = json.loads((ckpt_dir / f"manifest_{step:08d}.json").read_text())
    for path, like in leaves_with_path(like_tree):
        key = path_key(path)
        arr = data[key]
        assert arr.shape == tuple(like.shape), (key, arr.shape, like.shape)
        if manifest["dtypes"].get(key) == BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        yield t.to(_torch_dtype(like.dtype))


def restore_checkpoint(ckpt_dir, step: int, like_tree, *, device=None):
    """Step ``step`` in the structure of ``like_tree`` (``read_leaves``)
    as tensors on ``device`` (the card unless the caller names
    another)."""
    dev = _resolve_device(device, "restore_checkpoint")
    return unflatten(like_tree, [t.to(dev) for t in
                                 read_leaves(ckpt_dir, step, like_tree)])


class AsyncCheckpointer:
    """Copy to host memory, then write on a background thread; wait()
    joins the writer.  The copy is taken before ``save`` returns: a
    tensor is mutable (the JAX package's arrays are not), and the step
    after the save writes the parameters in place."""

    def __init__(self, ckpt_dir):
        self.ckpt_dir = Path(ckpt_dir)
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree, *, copy: bool = True):
        """Write ``tree`` as step ``step`` on the background thread;
        ``copy=False`` where the tree is host tensors of its own, which
        nothing writes after the call."""
        host_tree = tree if not copy else tree_map(
            lambda t: t.detach().to("cpu", copy=True) if torch.is_tensor(t)
            else np.array(t, copy=True), tree)
        self.wait()
        self._thread = threading.Thread(
            target=save_checkpoint, args=(self.ckpt_dir, step, host_tree),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
