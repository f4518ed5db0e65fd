"""The distributed store's answers as plain data, for either package
(``tests/_dist_fault_schedules.py``, ``tests/_dist_battery.py``).  Imports
neither JAX nor PyTorch, so a rank process that runs the battery loads no
JAX."""
from __future__ import annotations

import numpy as np


def host(x):
    """A JAX array or a (CPU or CUDA) torch tensor as numpy."""
    if type(x).__module__.startswith("torch"):
        x = x.cpu()
    return np.asarray(x)


def plain(x):
    """JSON-able data of a result, tuple or array."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.bool_,)):
        return bool(x)
    if isinstance(x, (tuple, list)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if hasattr(x, "shape"):
        return host(x).tolist()
    return str(x)


def _digest(name, r):
    """The answer of a client op, as lists (every lane and field the
    result holds, values by their first word)."""
    if name == "put":
        return [host(r.ok).tolist(), host(r.addrs).tolist(), r.retries,
                host(r.replicas).tolist()]
    if name == "get":
        f = host(r.found).astype(bool)
        return [f.tolist(), host(r.addrs).tolist(),
                (host(r.values)[:, 0] * f).tolist(),
                host(r.routed).tolist(), host(r.hops).tolist()]
    if name == "delete":
        return [host(r.ok).tolist(), host(r.found).tolist(), r.retries,
                host(r.replicas).tolist()]
    n = int(host(r.count))
    return [n, host(r.keys)[:n].tolist(), host(r.addrs)[:n].tolist(),
            r.complete, list(r.missing_groups)]
