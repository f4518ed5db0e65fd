"""Build and load the CUDA kernels of ``kernels/csrc``.

Each ``.cu`` source (with the ``.cuh`` headers it includes) is compiled
at first use into a shared library with a plain C interface, one
``nvcc`` per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <name>.so <name>.cu

The libraries go to ``build/repro_torch/<hash of the sources>/`` at the
root of the checkout and are loaded with ``ctypes``.  No PyTorch header
is included, so a build takes seconds.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I64 = ctypes.c_longlong
INT = ctypes.c_int


class Leaf(ctypes.Structure):
    """histore::Leaf (csrc/window_scan.cuh): one leaf of a state stacked
    along [R, G], the row of replica r of group g at p + r * sr + g * sg
    elements."""
    _fields_ = [("p", P), ("sr", ctypes.c_int64), ("sg", ctypes.c_int64)]


class HashTables(ctypes.Structure):
    """group_probe.cu's HashTables: the [G] stacked hash leaves."""
    _fields_ = [(n, Leaf) for n in ("sig", "fp", "addr", "fill")]


class StackedReplicas(ctypes.Structure):
    """histore::StackedReplicas<K> (csrc/window_scan.cuh): the [R, G]
    stacked backups; one layout at both key widths (a Leaf is a pointer
    and two strides in elements)."""
    _fields_ = [(n, Leaf) for n in ("skeys", "saddrs", "lkeys", "laddrs",
                                    "lops", "applied", "tail")]


# name of each C entry point -> its argtypes (pointers and the stream as
# c_void_p, so ctypes never cuts a 64-bit address)
SIGNATURES = {
    "hash_probe": {
        "histore_hash_probe": ([P] * 8 + [I64, I64, INT, INT, P], INT),
    },
    "sorted_search": {
        "histore_sorted_search": ([P] * 8 + [I64, I64, INT, INT, P], INT),
        "histore_range_query": ([P, P] + [I64] * 4 + [P, I64, P, I64, P, P,
                                                      P, I64, INT, I64, INT,
                                                      INT, I64, P], INT),
    },
    "merge": {
        "histore_merge_scratch_bytes": ([I64, I64], I64),
        "histore_merge": ([P] * 9 + [I64, I64, P], INT),
    },
    "backup_probe": {
        "histore_backup_probe": ([P] * 7 + [I64, INT, I64, I64, INT, INT, P],
                                 INT),
    },
    "group_probe": {
        "histore_group_probe": ([P] * 7 + [I64, INT, I64, INT, INT, INT, I64,
                                           I64, INT, INT, INT, INT, P], INT),
    },
    "sort_stable": {
        "histore_sort_stable_scratch_bytes": ([I64, I64], I64),
        "histore_sort_stable": ([P] * 5 + [I64, I64, P], INT),
    },
    "bitonic_sort": {
        "histore_bitonic_sort": ([P] * 4 + [I64, I64, P], INT),
    },
    "legacy_hash_probe": {
        "histore_legacy_hash_probe": ([P] * 9 + [I64, INT, INT, P], INT),
        "histore_legacy_hash_probe_keys": ([P] * 7 + [I64, I64, INT, INT, P],
                                           INT),
    },
    "legacy_sorted_search": {
        "histore_legacy_sorted_search": ([P] * 6 + [I64, I64, INT, INT, P],
                                         INT),
    },
    "mamba_scan": {
        "histore_mamba_scan": ([P] * 7 + [I64] + [INT] * 4 + [P], INT),
    },
}

# the int64-key entry point of each int32 one above that has one: the same
# template instantiated for int64_t keys, with the same arguments
for _lib, _fn in (("hash_probe", "histore_hash_probe"),
                  ("sorted_search", "histore_sorted_search"),
                  ("sorted_search", "histore_range_query"),
                  ("merge", "histore_merge_scratch_bytes"),
                  ("merge", "histore_merge"),
                  ("backup_probe", "histore_backup_probe"),
                  ("group_probe", "histore_group_probe"),
                  ("legacy_hash_probe", "histore_legacy_hash_probe_keys")):
    SIGNATURES[_lib][_fn + "_i64"] = SIGNATURES[_lib][_fn]

_lock = threading.Lock()
_libs: dict = {}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are built "
            "from kernels/csrc at first use and need the CUDA toolkit")
    return nvcc


def _digest() -> str:
    """Hash of the flags and of every source and header in csrc, so an
    edit to a shared ``.cuh`` builds anew too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Build every source that has no library yet and load them all.
    Returns {name: ctypes.CDLL}; raises on a failed compile."""
    with _lock:
        if _libs:
            return _libs
        out_dir = BUILD_DIR / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in SIGNATURES:
            so = out_dir / f"{name}.so"
            if so.exists():
                continue
            tmp = out_dir / f"{name}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        errors = []
        for name, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}.cu:\n{log}")
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        libs = {}
        for name, fns in SIGNATURES.items():
            lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
            for fn, (argtypes, restype) in fns.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            libs[name] = lib
        BUILD_INFO.update(seconds=time.perf_counter() - t0,
                          compiled=sorted(procs), dir=str(out_dir))
        _libs.update(libs)
        return _libs


def lib(name: str):
    return build()[name]
