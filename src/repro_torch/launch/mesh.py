"""Meshes as layout plans (port of ``repro/launch/mesh.py``).

A mesh is a dict of axis sizes in axis order, such as ``{"data": 16,
"model": 16}``: what ``sharding/partition.py``'s planner reads of one
(its axis names and sizes).  The JAX package builds a ``jax.sharding.Mesh``
over real or forced host devices; the port has one card and no SPMD
partitioner, so its mesh places nothing: it says how a deployment would
split the state, and the dry run divides by its device count.
"""
from __future__ import annotations

import math


def production_mesh(*, multi_pod: bool = False) -> dict:
    """16 x 16 = 256 devices ("data", "model"); with ``multi_pod`` a
    leading "pod" axis of 2 (512 devices)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def local_mesh() -> dict:
    """One card."""
    return {"data": 1, "model": 1}


def parse_mesh(text: str) -> dict:
    """"1" -> ``local_mesh()``; "16x16" / "2x16x16" -> the production
    meshes; any other "AxB" -> {"data": A, "model": B}."""
    dims = [int(d) for d in text.lower().split("x")]
    if dims == [1]:
        return local_mesh()
    if len(dims) == 2:
        return {"data": dims[0], "model": dims[1]}
    if len(dims) == 3:
        return {"pod": dims[0], "data": dims[1], "model": dims[2]}
    raise ValueError(f"mesh {text!r}: want 1, AxB or PxAxB")


def mesh_name(mesh: dict) -> str:
    return "x".join(str(n) for n in mesh.values())


def n_devices(mesh: dict) -> int:
    return math.prod(mesh.values())
