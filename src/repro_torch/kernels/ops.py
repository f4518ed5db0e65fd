"""The kernel-dispatch surface of the index hot path (port of
``repro/kernels/ops.py``).

Every routed op body calls THESE functions — ``probe`` / ``search`` /
``range_query`` / ``range_query_stacked`` / ``merge`` / ``backup_probe``
/ ``group_probe`` / ``group_probe_stacked`` / ``sort`` — never a kernel
directly.  Each
takes the HiStoreConfig and routes by the device of the tensors it is
given:

  * a CUDA tensor launches the hand-written CUDA kernel
    (``kernels/csrc``), or raises — there is no fallback;
  * a CPU tensor takes the plain PyTorch version in
    ``core/hash_index.py`` / ``core/sorted_index.py`` (the backup and
    group probes', ``backup_probe_plain``, ``group_probe_plain`` and
    ``group_probe_stacked_plain``, are here).

The probe kernels take raw keys and hash them on the card; the group
probe and the stacked SCAN read the store's stacked leaves by base
pointer and strides; a SCAN reads its lo and hi on the card.

Keys are int32 or int64, the dtype of the state's keys (``index.keys``,
``log.keys``), as the JAX package's ``ops`` reads ``index.keys.dtype``.
The hash probe, the search, the SCAN's range, the merge and the backup
probe have a CUDA entry point for each width (``histore_*`` and
``histore_*_i64``, one template instantiated twice), and each width's
launches are counted apart (``LAUNCHES["merge"]``,
``LAUNCHES["merge_i64"]``).  The CUDA wrappers take the tensors a call's
keys meet in at one dtype; a mix raises TypeError.  Where JAX's x64 path
falls back to jnp (its TPU kernels take int32 keys), the card launches
the int64 kernel: the answers are the same bits.

The routed ops cast the queries to the store's key width before they
choose a device, so both devices answer alike: ``search``, ``merge``,
``backup_probe`` and the group probes to their index's keys' dtype;
``probe``, whose hash table holds no keys, hashes them at their own
width (int32 or int64, other integer dtypes as int32), and the index
group passes them at its own.  The group probes and the stacked SCAN
have int32 kernels only and raise TypeError for an int64 store on every
device; the legacy ``hash_probe`` takes its keys as int32 on every
device, as ``sorted_search`` does.

``cfg.use_kernels`` keeps its values so configs compare field for field
with the JAX package: "on" and "auto" allow the routing above, "off"
makes a CUDA tensor raise rather than run the card on the plain path.
Both routes are bit-exact with the JAX kernels (the JAX package's
dispatch contract).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current
stream, raises on a nonzero launch status, and adds one to
``LAUNCHES[name]`` per launch (the range kernel counts as
``sorted_search``, whose library it is in).

The legacy wrappers ``hash_probe`` / ``sorted_search`` / ``sort_pairs``
(the JAX package's per-query DMA kernels and its bitonic network) sit at
the bottom with JAX's signatures.  As in JAX they ignore
``cfg.use_kernels``: a CUDA tensor launches their kernel (the legacy
probe's, too, takes the keys and hashes them on the card), a CPU tensor
takes its plain version (``legacy_hash_probe_plain``,
``legacy_sorted_search_plain``, ``bitonic_sort_plain``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import hash_index as hix
from repro_torch.core import log as lg
from repro_torch.core import sorted_index as six
from repro_torch.core import tree
from repro_torch.core.hashing import I32, owner_group
from repro_torch.kernels import _build, ref

# launches of each CUDA kernel in this process (reset by callers that
# count the launches of one run)
LAUNCHES = {"hash_probe": 0, "sorted_search": 0, "merge": 0,
            "backup_probe": 0, "group_probe": 0, "sort_stable": 0,
            "legacy_hash_probe": 0, "legacy_sorted_search": 0,
            "bitonic_sort": 0, "hash_probe_i64": 0, "sorted_search_i64": 0,
            "merge_i64": 0, "backup_probe_i64": 0}

KEY_DTYPES = (I32, torch.int64)


def kernels_enabled(cfg, device) -> bool:
    """True when tensors on ``device`` are served by the CUDA kernels.
    Raises for use_kernels="off" on a CUDA device."""
    if torch.device(device).type != "cuda":
        return False
    if cfg.use_kernels == "off":
        raise ValueError(
            "use_kernels='off' with CUDA tensors: the card always runs the "
            "CUDA kernels; pass CPU tensors for the plain PyTorch path")
    return True


def active_path(cfg, device) -> str:
    """"kernel" or "torch": which path serves index ops on ``device``."""
    return "kernel" if kernels_enabled(cfg, device) else "torch"


def _check(name, t, dtype, ndim=1):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(dev, fn, *args):
    """fn(*args, stream) on ``dev``'s current stream.  The current device
    is switched (a torch.cuda.device context) only when ``dev`` is not
    it already."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


# the directory's levels, once per (cap, fanout)
_levels = functools.lru_cache(maxsize=None)(six.directory_levels)


def _c(lib: str, fn: str):
    """The C entry point ``fn`` of kernel library ``lib`` (built on first
    use)."""
    return getattr(_build.lib(lib), fn)


def _raise_on(status: int, kernel: str):
    if status != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {status}")


def _key_width(kernel, *named):
    """The key dtype the (name, tensor) pairs ``named`` share, int32 or
    int64; anything else, or a mix, raises TypeError."""
    kinds = {t.dtype for _, t in named}
    if len(kinds) != 1 or not kinds <= set(KEY_DTYPES):
        raise TypeError(f"{kernel}: keys must share one dtype, torch.int32 "
                        f"or torch.int64; got " + ", ".join(
                            f"{n} {t.dtype}" for n, t in named))
    return kinds.pop()


def _wide(name: str, kd) -> str:
    """The int64 entry point or launch count of ``name`` for int64 keys."""
    return name if kd == I32 else name + "_i64"


def _as_key(keys):
    """Keys of an int32 or int64 store as they are; any other integer
    dtype as int32, the default width."""
    return keys if keys.dtype in KEY_DTYPES else keys.to(I32)


def _int32_store(kernel, keys):
    """The group probes' and the stacked SCAN's rule: their kernels take
    int32 keys only, so an int64 store raises on every device."""
    if keys.dtype != I32:
        raise TypeError(f"{kernel}: takes a store of int32 keys, got "
                        f"{keys.dtype} (its kernel has no int64 entry)")


# ---------------------------------------------------------------------------
# the CUDA wrappers
# ---------------------------------------------------------------------------
def _table_shape(kernel, sig, fp, addr, fill):
    """(nb, cs) of a hash table's leaves, sig/fp/addr [..., nb, CS] and
    fill [..., nb]; nb must be a power of two (the kernels mask the hash
    with nb - 1)."""
    nb, cs = sig.shape[-2:]
    if (fp.shape != sig.shape or addr.shape != sig.shape
            or fill.shape != sig.shape[:-1]):
        raise ValueError(f"{kernel}: inconsistent table shapes")
    if nb & (nb - 1):
        raise ValueError(f"{kernel}: {nb} buckets, not a power of two")
    return nb, cs


def hash_probe_cuda(keys, sig, fp, addr, fill, slots_per_bucket: int):
    """keys: [Q] int32 or int64 (hashed on the card); sig/fp/addr: [nb,
    CS] int32 with nb a power of two; fill: [nb] int32.  Returns (addr
    int32, found bool, n_accesses int32)."""
    kd = _key_width("hash_probe", ("keys", keys))
    _check("keys", keys, kd)
    _check("fill", fill, I32)
    for n, t in (("sig", sig), ("fp", fp), ("addr", addr)):
        _check(n, t, I32, 2)
    nb, cs = _table_shape("hash_probe", sig, fp, addr, fill)
    Q = keys.shape[0]
    out = torch.empty((2, Q), dtype=I32, device=keys.device)
    found = torch.empty((Q,), dtype=torch.bool, device=keys.device)
    with torch.cuda.device(keys.device):
        st = _c("hash_probe", _wide("histore_hash_probe", kd))(
            keys.data_ptr(), sig.data_ptr(), fp.data_ptr(), addr.data_ptr(),
            fill.data_ptr(), out[0].data_ptr(), found.data_ptr(),
            out[1].data_ptr(), Q, nb, cs, slots_per_bucket, _stream(keys))
    _raise_on(st, "hash_probe")
    LAUNCHES[_wide("hash_probe", kd)] += 1
    return out[0], found, out[1]


def sorted_search_cuda(queries, keys, addrs, fanout: int):
    """queries: [Q] and keys: [cap] (ascending, INF-padded), both int32 or
    both int64; addrs: [cap] int32.  Returns (addr, found int32,
    n_accesses, pos, lower_bound), each [Q] int32."""
    kd = _key_width("sorted_search", ("queries", queries), ("keys", keys))
    for n, t in (("queries", queries), ("keys", keys)):
        _check(n, t, kd)
    _check("addrs", addrs, I32)
    cap = keys.shape[0]
    if addrs.shape[0] != cap or cap < 1:
        raise ValueError("sorted_search: inconsistent shapes")
    Q = queries.shape[0]
    out = torch.empty((5, Q), dtype=I32, device=queries.device)
    p = out.data_ptr()
    st = _launch(queries.device,
                 _c("sorted_search", _wide("histore_sorted_search", kd)),
                 queries.data_ptr(), keys.data_ptr(), addrs.data_ptr(), p,
                 p + 4 * Q, p + 8 * Q, p + 12 * Q, p + 16 * Q, Q, cap, fanout,
                 _levels(cap, fanout))
    _raise_on(st, "sorted_search")
    LAUNCHES[_wide("sorted_search", kd)] += 1
    return out.unbind(0)


def _range_bounds(kernel, lo, hi, shape, kd=I32):
    for n, t in (("lo", lo), ("hi", hi)):
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {n}: expected a CUDA tensor, got "
                             f"{t.device}")
        if t.dtype != kd:
            raise TypeError(f"{kernel}: {n}: expected {kd}, got {t.dtype}")
        if tuple(t.shape) not in shape:
            raise ValueError(f"{kernel}: {n} has shape {tuple(t.shape)}, "
                             f"expected {shape[0]}")


def range_query_cuda(keys, addrs, lo, hi, limit: int, fanout: int):
    """The SCAN [lo, hi] of one replica in one launch.  keys: [cap] int32
    or int64 (ascending, INF-padded), addrs: [cap] int32; lo, hi: 0-d (or
    [1]) CUDA tensors of the keys' dtype, read on the card.  Returns (keys
    [limit] of the keys' dtype, addrs [limit] int32, count 0-d int32), as
    sorted_index.range_query."""
    kd = _key_width("range_query", ("keys", keys))
    _check("keys", keys, kd)
    _check("addrs", addrs, I32)
    _range_bounds("range_query", lo, hi, ((), (1,)), kd)
    cap = keys.shape[0]
    if addrs.shape[0] != cap or cap < 1 or limit < 0:
        raise ValueError("range_query: inconsistent shapes")
    dev = keys.device
    out = torch.empty((2 * limit + 1,), dtype=I32, device=dev)
    ok = out[:limit] if kd == I32 else torch.empty((limit,), dtype=kd,
                                                    device=dev)
    p = out.data_ptr()
    st = _launch(dev, _c("sorted_search", _wide("histore_range_query", kd)),
                 keys.data_ptr(), addrs.data_ptr(), 0, 0, 0, 0,
                 lo.data_ptr(), 0, hi.data_ptr(), 0, ok.data_ptr(),
                 p + 4 * limit, p + 8 * limit, 1, 1, cap, fanout,
                 _levels(cap, fanout), limit)
    _raise_on(st, "range_query")
    LAUNCHES[_wide("sorted_search", kd)] += 1
    return ok, out[limit:2 * limit], out[2 * limit]


def range_query_stacked_cuda(keys, addrs, lo, hi, limit: int, fanout: int):
    """The SCANs [lo[g], hi[g]] of every replica r of every group g in one
    launch.  keys/addrs: [R, G, cap] int32, the store's stacked sorted
    leaves, read in place through their strides (each row contiguous);
    lo, hi: [G] int32 CUDA tensors, any stride (an expanded 0-d works).
    Returns (keys [G, R, limit], addrs [G, R, limit], counts [G, R]),
    int32."""
    if keys.dim() != 3:
        raise ValueError(f"range_query_stacked: expected [R, G, cap] "
                         f"leaves, got {tuple(keys.shape)}")
    R, G, cap = keys.shape
    kl = _leaf("sorted keys", keys, I32, (R, G, cap), 2)
    al = _leaf("sorted addrs", addrs, I32, (R, G, cap), 2)
    _range_bounds("range_query_stacked", lo, hi, ((G,),))
    if R < 1 or G < 1 or cap < 1 or limit < 0:
        raise ValueError(f"range_query_stacked: {G} groups, {R} replicas "
                         f"of {cap} slots, limit {limit}")
    n = G * R * limit
    out = torch.empty((2 * n + G * R,), dtype=I32, device=keys.device)
    p = out.data_ptr()
    st = _launch(keys.device, _c("sorted_search", "histore_range_query"),
                 kl.p, al.p, kl.sr, kl.sg, al.sr, al.sg, lo.data_ptr(),
                 lo.stride(0), hi.data_ptr(), hi.stride(0), p, p + 4 * n,
                 p + 8 * n, G, R, cap, fanout, _levels(cap, fanout), limit)
    _raise_on(st, "range_query_stacked")
    LAUNCHES["sorted_search"] += 1
    return (out[:n].view(G, R, limit), out[n:2 * n].view(G, R, limit),
            out[2 * n:].view(G, R))


def merge_cuda(ekeys, eaddrs, bkeys, baddrs, bops):
    """ekeys: [cap] (ascending, INF-padded) and bkeys: [m], both int32 or
    both int64; eaddrs: [cap] and baddrs: [m] int32; bops: [m] int8, the
    log batch (op 0 invalid / 1 PUT / 2 DEL).  Returns (new_keys [cap] of
    the keys' dtype, new_addrs [cap], size [1])."""
    kd = _key_width("merge", ("ekeys", ekeys), ("bkeys", bkeys))
    for n, t, dt in (("ekeys", ekeys, kd), ("eaddrs", eaddrs, I32),
                     ("bkeys", bkeys, kd), ("baddrs", baddrs, I32)):
        _check(n, t, dt)
    _check("bops", bops, torch.int8)
    cap = ekeys.shape[0]
    m = bkeys.shape[0]
    if (eaddrs.shape[0] != cap or baddrs.shape[0] != m
            or bops.shape[0] != m or cap < 1 or m < 1):
        raise ValueError("merge: inconsistent shapes")
    dev = ekeys.device
    nbytes = _c("merge", _wide("histore_merge_scratch_bytes", kd))(cap, m)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    nk = torch.empty((cap,), dtype=kd, device=dev)
    na = torch.empty((cap,), dtype=I32, device=dev)
    size = torch.empty((1,), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        st = _c("merge", _wide("histore_merge", kd))(
            ekeys.data_ptr(), eaddrs.data_ptr(), bkeys.data_ptr(),
            baddrs.data_ptr(), bops.data_ptr(), nk.data_ptr(), na.data_ptr(),
            size.data_ptr(), scratch.data_ptr(), cap, m, _stream(ekeys))
    _raise_on(st, "merge")
    LAUNCHES[_wide("merge", kd)] += 1
    return nk, na, size


def _ptr_table(dev, ptrs):
    """The device pointers as an int64 tensor on ``dev``, copied on the
    current stream.  The copy is from pageable memory and non-blocking:
    CUDA stages the 8 bytes a pointer before the call returns, so
    the host neither waits for the card nor keeps the buffer alive."""
    return torch.tensor(ptrs, dtype=torch.int64).to(dev, non_blocking=True)


def _replica_ptrs(kernel, sorted_r, blogs_r, kd=I32):
    """(R, cap, lcap, a device int64 table of the 7 R device pointers) of
    the R replica and log states the backup probe takes, their keys of
    dtype ``kd``; the kernel reads the table, so it takes any R."""
    R = len(sorted_r)
    if R < 1 or len(blogs_r) != R:
        raise ValueError(f"{kernel}: at least one replica with one log "
                         f"each, got {R} and {len(blogs_r)}")
    cap = sorted_r[0].keys.shape[0]
    lcap = blogs_r[0].keys.shape[0]
    if cap < 1 or lcap < 1:
        raise ValueError(f"{kernel}: empty replica or log")
    ptrs = []
    for srt, blog in zip(sorted_r, blogs_r):
        for n, t, dtype, shape in (
                ("sorted keys", srt.keys, kd, (cap,)),
                ("sorted addrs", srt.addrs, I32, (cap,)),
                ("log keys", blog.keys, kd, (lcap,)),
                ("log addrs", blog.addrs, I32, (lcap,)),
                ("log ops", blog.ops, torch.int8, (lcap,)),
                ("log applied", blog.applied, I32, ()),
                ("log tail", blog.tail, I32, ())):
            _check(n, t, dtype, len(shape))
            if tuple(t.shape) != shape:
                raise ValueError(f"{kernel}: {n} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            ptrs.append(t.data_ptr())
    return R, cap, lcap, _ptr_table(sorted_r[0].keys.device, ptrs)


def backup_probe_cuda(keys, rep_sel, sorted_r, blogs_r, fanout: int):
    """keys: [Q] int32 or int64; rep_sel: [Q, R] int32; sorted_r / blogs_r:
    R SortedIndex / UpdateLog states (keys of the queries' dtype, addrs
    int32, ops int8, applied and tail 0-d int32 on the card, read there).
    One call takes the R pointer sets, as a table on the card: nothing is
    stacked.  Returns (addr, found int32, n_accesses), each [Q] int32."""
    kd = _key_width("backup_probe", ("keys", keys),
                    *[(f"replica {r} keys", s.keys)
                      for r, s in enumerate(sorted_r)],
                    *[(f"log {r} keys", b.keys)
                      for r, b in enumerate(blogs_r)])
    _check("keys", keys, kd)
    _check("rep_sel", rep_sel, I32, 2)
    R, cap, lcap, table = _replica_ptrs("backup_probe", sorted_r, blogs_r,
                                        kd)
    Q = keys.shape[0]
    if rep_sel.shape != (Q, R):
        raise ValueError("backup_probe: inconsistent shapes")
    levels = six.directory_levels(cap, fanout)
    out = torch.empty((4, Q), dtype=I32, device=keys.device)
    with torch.cuda.device(keys.device):
        st = _c("backup_probe", _wide("histore_backup_probe", kd))(
            keys.data_ptr(), rep_sel.data_ptr(),
            table.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), Q, R, cap, lcap, fanout, levels,
            _stream(keys))
    _raise_on(st, "backup_probe")
    LAUNCHES[_wide("backup_probe", kd)] += 1
    return out[0], out[1], out[2]


def _leaf(name, t, dtype, shape, lead):
    """_build.Leaf of a state leaf of ``shape`` whose first ``lead`` axes
    ([G] or [R, G]) are stacked: read in place by strides, so each row
    must be contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    stride = t.stride()
    step = 1
    for d in range(len(shape) - 1, lead - 1, -1):
        if shape[d] > 1 and stride[d] != step:
            raise ValueError(f"{name}: expected contiguous rows")
        step *= shape[d]
    sr, sg = stride[:lead] if lead == 2 else (0, stride[0])
    return _build.Leaf(t.data_ptr(), sr, sg)


def group_probe_cuda(rkeys, rep_sel, hidx, bsorted, blog,
                     slots_per_bucket: int, fanout: int, groups=None,
                     g0: int = 0):
    """The fused GET probe of G servers in one call.  rkeys: [G, Q] int32,
    the keys each server received (hashed on the card); rep_sel: [G, Q, R]
    int32, or None to select by each key's owner group (``replica_select``,
    computed on the card); hidx: a HashIndex with leaves [G, nb, CS] and
    [G, nb]; bsorted / blog: SortedIndex / UpdateLog states with leaves
    [R, G, cap] / [R, G, lcap] and applied and tail [R, G] (read on the
    card).  The leaves are read in place through their strides.  The
    stack's G servers are the store's groups g0 .. g0 + G - 1 of
    ``groups`` (default G: the whole store).  Returns (h_addr, h_found,
    h_acc, b_addr, b_found, b_acc, owner group), each [G, Q], the found
    flags bool and the rest int32."""
    _check("rkeys", rkeys, I32, 2)
    G, Q = rkeys.shape
    groups = G if groups is None else int(groups)
    if g0 < 0 or groups < g0 + G:
        raise ValueError(f"group_probe: servers {g0}..{g0 + G - 1} are not "
                         f"groups of a store of {groups}")
    nb, cs = _table_shape("group_probe", *hidx)
    R = blog.tail.shape[0]
    cap, lcap = bsorted.keys.shape[-1], blog.keys.shape[-1]
    if G < 1 or R < 1 or cap < 1 or lcap < 1:
        raise ValueError(f"group_probe: {G} groups, {R} replicas of {cap} "
                         f"slots, logs of {lcap}: none may be empty")
    if rep_sel is not None:
        _check("rep_sel", rep_sel, I32, 3)
        if rep_sel.shape != (G, Q, R):
            raise ValueError("group_probe: inconsistent shapes")
    tables = _build.HashTables(
        *[_leaf(n, t, I32, (G, nb, cs), 1)
          for n, t in zip(("sig", "fp", "addr"), hidx[:3])],
        _leaf("fill", hidx.fill, I32, (G, nb), 1))
    reps = _build.StackedReplicas(
        _leaf("sorted keys", bsorted.keys, I32, (R, G, cap), 2),
        _leaf("sorted addrs", bsorted.addrs, I32, (R, G, cap), 2),
        _leaf("log keys", blog.keys, I32, (R, G, lcap), 2),
        _leaf("log addrs", blog.addrs, I32, (R, G, lcap), 2),
        _leaf("log ops", blog.ops, torch.int8, (R, G, lcap), 2),
        _leaf("log applied", blog.applied, I32, (R, G), 2),
        _leaf("log tail", blog.tail, I32, (R, G), 2))
    out = torch.empty((5, G, Q), dtype=I32, device=rkeys.device)
    found = torch.empty((2, G, Q), dtype=torch.bool, device=rkeys.device)
    best = torch.empty((G, Q), dtype=I32, device=rkeys.device)
    with torch.cuda.device(rkeys.device):
        st = _c("group_probe", "histore_group_probe")(
            rkeys.data_ptr(), None if rep_sel is None else rep_sel.data_ptr(),
            ctypes.addressof(tables), ctypes.addressof(reps),
            out.data_ptr(), found.data_ptr(), best.data_ptr(), Q, G, nb, cs,
            slots_per_bucket, R, cap, lcap, fanout,
            six.directory_levels(cap, fanout), groups, int(g0),
            _stream(rkeys))
    _raise_on(st, "group_probe")
    LAUNCHES["group_probe"] += 1
    return out[0], found[0], out[1], out[2], found[1], out[3], out[4]


def _check_pairs(kernel, keys, vals):
    _check("keys", keys, I32, 2)
    _check("vals", vals, I32, 2)
    if vals.shape != keys.shape:
        raise ValueError(f"{kernel}: keys {tuple(keys.shape)} and vals "
                         f"{tuple(vals.shape)} differ")
    return keys.shape


def sort_stable_cuda(keys, vals):
    """keys/vals: [R, T] int32, any T.  Rowwise stable sort by key, the
    payload riding the same permutation.  Returns (keys, vals)."""
    R, T = _check_pairs("sort_stable", keys, vals)
    dev = keys.device
    ok = torch.empty_like(keys)
    ov = torch.empty_like(vals)
    nbytes = _c("sort_stable", "histore_sort_stable_scratch_bytes")(R, T)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        st = _c("sort_stable", "histore_sort_stable")(
            keys.data_ptr(), vals.data_ptr(), ok.data_ptr(), ov.data_ptr(),
            scratch.data_ptr(), R, T, _stream(keys))
    _raise_on(st, "sort_stable")
    LAUNCHES["sort_stable"] += 1
    return ok, ov


def bitonic_sort_cuda(keys, vals):
    """keys/vals: [R, T] int32, T a power of two.  JAX's bitonic network,
    compare-exchange for compare-exchange, so payloads of tied keys land
    where its network puts them.  Returns (keys, vals)."""
    R, T = _check_pairs("bitonic_sort", keys, vals)
    if T & (T - 1):
        raise ValueError(f"bitonic_sort: T must be a power of two, got {T}")
    ok = torch.empty((R, T), dtype=I32, device=keys.device)
    ov = torch.empty((R, T), dtype=I32, device=keys.device)
    st = _launch(keys.device, _c("bitonic_sort", "histore_bitonic_sort"),
                 keys.data_ptr(), vals.data_ptr(), ok.data_ptr(),
                 ov.data_ptr(), R, T)
    _raise_on(st, "bitonic_sort")
    LAUNCHES["bitonic_sort"] += 1
    return ok, ov


def legacy_hash_probe_keys_cuda(keys, sig, fp, addr, slots_per_bucket: int):
    """keys: [Q] int32 (hashed on the card, the bucket h1 & (nb - 1) as
    ``hashing.descriptors`` takes it for any nb); sig/fp/addr: [nb, CS]
    int32 (no fill: a miss counts the row's nonzero signatures).  Returns
    (addr int32, found bool, n_accesses int32)."""
    _check("keys", keys, I32)
    for n, t in (("sig", sig), ("fp", fp), ("addr", addr)):
        _check(n, t, I32, 2)
    if fp.shape != sig.shape or addr.shape != sig.shape:
        raise ValueError("legacy_hash_probe: inconsistent table shapes")
    nb, cs = sig.shape
    Q = keys.shape[0]
    out = torch.empty((2, Q), dtype=I32, device=keys.device)
    found = torch.empty((Q,), dtype=torch.bool, device=keys.device)
    st = _launch(keys.device,
                 _c("legacy_hash_probe", "histore_legacy_hash_probe_keys"),
                 keys.data_ptr(), sig.data_ptr(), fp.data_ptr(),
                 addr.data_ptr(), out[0].data_ptr(), found.data_ptr(),
                 out[1].data_ptr(), Q, nb, cs, slots_per_bucket)
    _raise_on(st, "legacy_hash_probe")
    LAUNCHES["legacy_hash_probe"] += 1
    return out[0], found, out[1]


def legacy_hash_probe_cuda(bucket, qsig, qfp, sig, fp, addr,
                           slots_per_bucket: int):
    """The counterpart of JAX's ``hash_probe_kernel``, which takes
    descriptors: bucket/qsig/qfp: [Q] int32; sig/fp/addr: [nb, CS] int32
    (no fill: a miss counts the row's nonzero signatures).  Returns
    (addr, found int32, n_accesses), each [Q] int32."""
    for n, t in (("bucket", bucket), ("qsig", qsig), ("qfp", qfp)):
        _check(n, t, I32)
    for n, t in (("sig", sig), ("fp", fp), ("addr", addr)):
        _check(n, t, I32, 2)
    Q = bucket.shape[0]
    if (qsig.shape[0] != Q or qfp.shape[0] != Q or fp.shape != sig.shape
            or addr.shape != sig.shape):
        raise ValueError("legacy_hash_probe: inconsistent shapes")
    out = torch.empty((3, Q), dtype=I32, device=bucket.device)
    with torch.cuda.device(bucket.device):
        st = _c("legacy_hash_probe", "histore_legacy_hash_probe")(
            bucket.data_ptr(), qsig.data_ptr(), qfp.data_ptr(),
            sig.data_ptr(), fp.data_ptr(), addr.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            Q, sig.shape[1], slots_per_bucket, _stream(bucket))
    _raise_on(st, "legacy_hash_probe")
    LAUNCHES["legacy_hash_probe"] += 1
    return out[0], out[1], out[2]


def legacy_sorted_search_cuda(queries, keys, addrs, fanout: int):
    """queries: [Q] int32; keys/addrs: [cap] int32 (ascending,
    INF-padded).  Returns (addr, found int32, n_accesses), each [Q]
    int32."""
    for n, t in (("queries", queries), ("keys", keys), ("addrs", addrs)):
        _check(n, t, I32)
    cap = keys.shape[0]
    if addrs.shape[0] != cap or cap < 1:
        raise ValueError("legacy_sorted_search: inconsistent shapes")
    Q = queries.shape[0]
    out = torch.empty((3, Q), dtype=I32, device=queries.device)
    p = out.data_ptr()
    st = _launch(queries.device,
                 _c("legacy_sorted_search", "histore_legacy_sorted_search"),
                 queries.data_ptr(), keys.data_ptr(), addrs.data_ptr(), p,
                 p + 4 * Q, p + 8 * Q, Q, cap, fanout, _levels(cap, fanout))
    _raise_on(st, "legacy_sorted_search")
    LAUNCHES["legacy_sorted_search"] += 1
    return out.unbind(0)


def backup_probe_plain(cfg, sorted_r, blogs_r, keys, rep_sel):
    """The plain PyTorch version of the backup probe (mirror of the JAX
    package's ``_backup_probe_jnp``): for each replica r, the newest-wins
    pending-log lookup, else the sorted search; a lane takes the answer
    of each selected replica in turn, so the LAST selected one wins, with
    n_accesses = search levels + 1.  Returns (addr, found bool,
    n_accesses)."""
    addr_b = torch.full(keys.shape, -1, dtype=I32, device=keys.device)
    found_b = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    acc_b = torch.zeros(keys.shape, dtype=I32, device=keys.device)
    for r, (srt, blog) in enumerate(zip(sorted_r, blogs_r)):
        a_s, f_s, c_s = six.search(srt, keys, cfg.fanout)
        hit, op, praw = lg.pending_lookup(blog, keys)
        put = op == six.OP_PUT
        a_r = torch.where(hit, torch.where(put, praw, -1), a_s)
        f_r = torch.where(hit, put, f_s)
        sel = rep_sel[:, r] != 0
        addr_b = torch.where(sel, a_r, addr_b)
        found_b = torch.where(sel, f_r, found_b)
        acc_b = torch.where(sel, c_s + 1, acc_b)
    return addr_b, found_b, acc_b


def group_probe_plain(cfg, hidx, sorted_r, blogs_r, keys, rep_sel):
    """The plain PyTorch version of the group probe (mirror of the JAX
    package's jnp path of ``group_probe``): the hash lookup and the
    backup probe.  Returns (h_addr, h_found bool, h_acc, b_addr, b_found
    bool, b_acc)."""
    return (*hix.lookup(hidx, keys, cfg),
            *backup_probe_plain(cfg, sorted_r, blogs_r, keys, rep_sel))


def replica_select(og, g: int, G: int, R: int):
    """rep_sel [Q, R] int32 of server g for lanes whose keys' owner groups
    are ``og``: lane i selects replica r iff server g holds replica r of
    group og[i], which in the shifted layout is group (g - r - 1) mod G
    (the rule group_probe.cu applies on the card)."""
    return torch.stack([(og == (g - r - 1) % G).to(I32) for r in range(R)],
                       dim=1)


def server_inputs(hidx, bsorted, blog, rk, g: int, groups=None,
                  g0: int = 0):
    """What the stack's server g (the store's group g0 + g of ``groups``,
    default the stack's size) reads in its group probe for its lanes
    ``rk`` [Q], from the stacked leaves (hidx [G, ...], bsorted / blog
    [R, G, ...]): its hash, the R sorted replicas and backup logs it
    holds, and ``rep_sel`` [Q, R] from the lanes' owner groups.  Returns
    (hash, sorted, logs, rep_sel), the arguments of the per-group
    ``group_probe``."""
    R, G = blog.tail.shape
    groups = G if groups is None else groups
    srt = tuple(tree.at(bsorted, r, g) for r in range(R))
    blg = tuple(tree.at(blog, r, g) for r in range(R))
    return (tree.at(hidx, g), srt, blg,
            replica_select(owner_group(rk, groups), g0 + g, groups, R))


def group_probe_stacked_plain(cfg, hidx, bsorted, blog, rk, groups=None,
                              g0: int = 0):
    """The plain version of the stacked group probe: for each server g of
    the stack (the store's group g0 + g of ``groups``), group_probe_plain
    over ``server_inputs``.  Returns (h_addr, h_found bool, h_acc,
    b_addr, b_found bool, b_acc, owner group), each [G, Q]."""
    groups = rk.shape[0] if groups is None else groups
    outs = []
    for g in range(rk.shape[0]):
        h, srt, blg, sel = server_inputs(hidx, bsorted, blog, rk[g], g,
                                         groups, g0)
        outs.append(group_probe_plain(cfg, h, srt, blg, rk[g], sel))
    return (*[torch.stack(x) for x in zip(*outs)],
            owner_group(rk, groups))


def _compare_exchange(keys, vals, j, asc):
    """One step of the bitonic network at partner distance j over [R, T]:
    the pair (i, i + j) with bit j of i clear swaps when ``asc[i]`` and
    key_lo > key_hi, or when not ``asc[i]`` and key_lo < key_hi."""
    R, T = keys.shape
    k = keys.reshape(R, T // (2 * j), 2, j)
    v = vals.reshape(R, T // (2 * j), 2, j)
    a = asc.reshape(T // (2 * j), 2, j)[:, 0, :]
    lo_k, hi_k = k[:, :, 0], k[:, :, 1]
    swap = torch.where(a[None], lo_k > hi_k, lo_k < hi_k)
    k = torch.stack([torch.where(swap, hi_k, lo_k),
                     torch.where(swap, lo_k, hi_k)], dim=2)
    lo_v, hi_v = v[:, :, 0], v[:, :, 1]
    v = torch.stack([torch.where(swap, hi_v, lo_v),
                     torch.where(swap, lo_v, hi_v)], dim=2)
    return k.reshape(R, T), v.reshape(R, T)


def bitonic_sort_plain(keys, vals):
    """The plain version of the bitonic sort: JAX's network
    (``_bitonic_sort.py``) as reshapes and ``torch.where``, stages 2, 4,
    ... T, distances stage / 2 ... 1, log2(T) (log2(T) + 1) / 2 steps.
    Not stable: the payloads of tied keys land where the network puts
    them.  T is a power of two."""
    T = keys.shape[1]
    idx = torch.arange(T, device=keys.device)
    stage = 2
    while stage <= T:
        asc = (idx // stage) % 2 == 0
        j = stage // 2
        while j >= 1:
            keys, vals = _compare_exchange(keys, vals, j, asc)
            j //= 2
        stage *= 2
    return keys, vals


# the plain versions of the stable sort (torch.sort(stable=True) and a
# gather, the JAX package's jnp path of ``sort``) and of the legacy probe
# and search are their oracles
sort_stable_plain = ref.ref_sort_pairs_stable
legacy_hash_probe_plain = ref.ref_hash_probe
legacy_sorted_search_plain = ref.ref_sorted_search


# ---------------------------------------------------------------------------
# the routed ops
# ---------------------------------------------------------------------------
def probe(cfg, index, keys):
    """GET probe on a HashIndex -> (addr, found bool, n_accesses); on the
    card the kernel hashes the keys, at their own width on both devices
    (the table holds no keys).  Bit-exact with hash_index.lookup."""
    keys = _as_key(keys)
    if not kernels_enabled(cfg, keys.device):
        return hix.lookup(index, keys, cfg)
    return hash_probe_cuda(keys.contiguous(), *index, cfg.slots_per_bucket)


def search(cfg, index, queries):
    """Point lookup on a SortedIndex -> (addr, found bool, n_accesses).
    Bit-exact with sorted_index.search."""
    queries = queries.to(index.keys.dtype)
    if not kernels_enabled(cfg, queries.device):
        return six.search(index, queries, cfg.fanout)
    addr, found, acc, _, _ = sorted_search_cuda(
        queries.contiguous(), index.keys, index.addrs, cfg.fanout)
    return addr, found.bool(), acc


def merge(cfg, index, keys, addrs, ops):
    """Apply a log batch to a SortedIndex (newest-wins, tombstones
    compact away) -> SortedIndex.  Bit-exact with sorted_index.merge."""
    keys = keys.to(index.keys.dtype)
    if not kernels_enabled(cfg, keys.device):
        return six.merge(index, keys, addrs, ops)
    nk, na, size = merge_cuda(index.keys, index.addrs, keys, addrs.to(I32),
                              ops.to(torch.int8))
    return six.SortedIndex(nk, na, size[0])


def _bound(x, dev, kd=I32):
    """lo or hi as a ``kd`` tensor on ``dev``: the caller's own tensor
    when it is one already (no copy), else a copy."""
    if torch.is_tensor(x) and x.dtype == kd and x.device == dev:
        return x
    return torch.as_tensor(x, dtype=kd, device=dev)


def range_query(cfg, index, lo, hi, limit: int):
    """SCAN [lo, hi] -> (keys [limit], addrs [limit], count).  On the card
    one launch gives the lower bound (the sorted-search kernel's descent)
    and the take; lo and hi are read there.  Bit-exact with
    sorted_index.range_query."""
    dev = index.keys.device
    if not kernels_enabled(cfg, dev):
        return six.range_query(index, lo, hi, limit)
    kd = index.keys.dtype
    return range_query_cuda(index.keys, index.addrs, _bound(lo, dev, kd),
                            _bound(hi, dev, kd), limit, cfg.fanout)


def range_query_stacked_plain(cfg, bsorted, lo, hi, limit: int):
    """The plain version of the stacked SCAN: sorted_index.range_query of
    replica r of group g, [lo[g], hi[g]], for every (g, r).  Returns
    (keys [G, R, limit], addrs [G, R, limit], counts [G, R])."""
    R, G = bsorted.keys.shape[:2]
    out = [[six.range_query(tree.at(bsorted, r, g), lo[g], hi[g], limit)
            for r in range(R)] for g in range(G)]
    return tuple(torch.stack([torch.stack([o[i] for o in row])
                              for row in out]) for i in range(3))


def range_query_stacked(cfg, bsorted, lo, hi, limit: int):
    """The distributed SCAN's range queries in one call: replica r of
    group g (the store's [R, G] sorted leaves, read in place on the card)
    over [lo[g], hi[g]] (lo, hi: [G]).  Returns (keys [G, R, limit],
    addrs [G, R, limit], counts [G, R]).  Bit-exact with
    range_query_stacked_plain."""
    dev = bsorted.keys.device
    _int32_store("range_query_stacked", bsorted.keys)
    if not kernels_enabled(cfg, dev):
        return range_query_stacked_plain(cfg, bsorted, lo, hi, limit)
    return range_query_stacked_cuda(bsorted.keys, bsorted.addrs,
                                    _bound(lo, dev), _bound(hi, dev), limit,
                                    cfg.fanout)


def backup_probe(cfg, sorted_r, blogs_r, keys, rep_sel):
    """Degraded lookup across the R sorted replicas and their pending
    logs, combined by ``rep_sel`` [Q, R] (later selected replicas
    overwrite earlier ones) -> (addr, found bool, n_accesses).
    Bit-exact with backup_probe_plain."""
    keys = keys.to(sorted_r[0].keys.dtype)
    if not kernels_enabled(cfg, keys.device):
        return backup_probe_plain(cfg, sorted_r, blogs_r, keys, rep_sel)
    addr, found, acc = backup_probe_cuda(
        keys.contiguous(), rep_sel.to(I32).contiguous(), sorted_r, blogs_r,
        cfg.fanout)
    return addr, found.bool(), acc


def group_probe(cfg, hidx, sorted_r, blogs_r, keys, rep_sel):
    """The fused GET probe of one group with JAX's signature: the hash
    chain walk and the replica-select backup probe (``rep_sel`` [Q, R])
    in one kernel call, the stacked kernel at G = 1 over copies of the R
    replica states.  Returns (h_addr, h_found bool, h_acc, b_addr,
    b_found bool, b_acc).  Bit-exact with group_probe_plain.

    On the card each call copies every leaf of the R replica states
    (torch.stack: R x (cap + lcap) entries and more) before the launch.
    The store's GET reads its stacked leaves in place through
    ``group_probe_stacked``; this signature serves callers that hold
    the replicas as separate states."""
    _int32_store("group_probe", sorted_r[0].keys)
    keys = keys.to(I32)
    if not kernels_enabled(cfg, keys.device):
        return group_probe_plain(cfg, hidx, sorted_r, blogs_r, keys, rep_sel)
    if len(sorted_r) < 1 or len(blogs_r) != len(sorted_r):
        raise ValueError(f"group_probe: at least one replica with one log "
                         f"each, got {len(sorted_r)} and {len(blogs_r)}")

    def one_group(states):
        return type(states[0])(*[torch.stack(x)[:, None]
                                 for x in zip(*states)])

    out = group_probe_cuda(
        keys.contiguous()[None], rep_sel.to(I32).contiguous()[None],
        type(hidx)(*[a[None] for a in hidx]), one_group(sorted_r),
        one_group(blogs_r), cfg.slots_per_bucket, cfg.fanout)
    return tuple(t[0] for t in out[:6])


def group_probe_stacked(cfg, hidx, bsorted, blog, rk, groups=None,
                        g0: int = 0):
    """The fused GET probe of the G servers of a distributed GET chunk in
    one call: server g probes its hash and the replicas it holds for its
    lanes ``rk[g]``, each lane selecting by its key's owner group (the
    JAX op body's ``rep_sel``).  hidx: HashIndex leaves [G, ...]; bsorted
    / blog: [R, G, ...] (the store's, or a rank's L of them: the store's
    groups g0 .. g0 + L - 1 of ``groups``); rk: [G, Q].  Returns (h_addr,
    h_found bool, h_acc, b_addr, b_found bool, b_acc, owner group), each
    [G, Q]; row g of the first six is group_probe's answer for server g.
    Bit-exact with group_probe_stacked_plain."""
    _int32_store("group_probe_stacked", bsorted.keys)
    rk = rk.to(I32)
    if not kernels_enabled(cfg, rk.device):
        return group_probe_stacked_plain(cfg, hidx, bsorted, blog, rk,
                                         groups, g0)
    return group_probe_cuda(rk.contiguous(), None, hidx, bsorted,
                            blog, cfg.slots_per_bucket, cfg.fanout, groups,
                            g0)


def sort(cfg, keys, vals):
    """Rowwise STABLE (key, payload) sort of [R, T] -> (keys, vals), any R
    and T.  Bit-exact with a stable argsort + gather.  The JAX package's
    per-dtype rule: its ``sort`` sends only int32 keys to its kernel and
    sorts any other key dtype with a stable argsort and take_along_axis.
    So on the card int32 keys launch the kernel and the payload comes back
    as int32, as JAX casts it on its kernel path; keys of any other dtype
    take ``sort_stable_plain`` and the payload keeps its dtype."""
    if not kernels_enabled(cfg, keys.device) or keys.dtype != I32:
        return sort_stable_plain(keys, vals)
    return sort_stable_cuda(keys.contiguous(), vals.to(I32).contiguous())


# ---------------------------------------------------------------------------
# legacy wrappers (the JAX package's per-query DMA kernels and its bitonic
# network, kept as the measured one-read-per-access models)
# ---------------------------------------------------------------------------
def hash_probe(index, keys, cfg, *, q_block: int = 256):
    """GET probe through the legacy per-query kernel.  index: HashIndex;
    keys: [Q].  Returns (addr, found bool, n_accesses); a miss counts
    ceil(occ / S) reads with occ the chain row's nonzero signatures (the
    fill the index keeps, so on its tables it equals ``probe``).  On the
    card the kernel hashes the keys (one launch).  The keys are taken as
    int32 on every device, as ``sorted_search`` takes its queries.
    ``q_block`` is JAX's query tile: the card needs none, any Q is
    taken."""
    if q_block < 1:
        raise ValueError(f"hash_probe: q_block must be >= 1, got {q_block}")
    keys = keys.to(I32)
    if keys.is_cuda:
        return legacy_hash_probe_keys_cuda(
            keys.contiguous(), index.sig, index.fp, index.addr,
            cfg.slots_per_bucket)
    b, sig, fp = hix.descriptors(index, keys)
    addr, found, acc = legacy_hash_probe_plain(
        b, sig, fp, index.sig, index.fp, index.addr,
        slots_per_bucket=cfg.slots_per_bucket)
    return addr, found.bool(), acc


def sorted_search(index, queries, *, fanout: int = 128, q_block: int = 256):
    """Point lookup on a SortedIndex through the legacy per-level kernel
    -> (addr, found bool, n_accesses = levels).  Requires int32 keys, as
    JAX asserts; ``q_block`` as in ``hash_probe``."""
    if index.keys.dtype != I32:
        raise TypeError(f"sorted_search: the kernel path uses int32 keys, "
                        f"got {index.keys.dtype}")
    if q_block < 1:
        raise ValueError(f"sorted_search: q_block must be >= 1, got "
                         f"{q_block}")
    q = queries.to(I32)
    if q.is_cuda:
        addr, found, acc = legacy_sorted_search_cuda(
            q.contiguous(), index.keys, index.addrs, fanout)
    else:
        addr, found, acc = legacy_sorted_search_plain(
            q, index.keys, index.addrs, fanout=fanout)
    return addr, found.bool(), acc


def sort_pairs(keys, vals, *, row_block: int = 8):
    """Rowwise (key, payload) sort through the bitonic network, [R, T]
    int32 with T a power of two (NOT stable on tied keys; ``sort`` is the
    stable dispatch).  Raises where JAX's kernel asserts: T not a power
    of two, or R not a multiple of min(row_block, R)."""
    keys, vals = keys.to(I32), vals.to(I32)
    R, T = keys.shape
    if T & (T - 1):
        raise ValueError(f"sort_pairs: T must be a power of two, got {T}")
    RB = min(row_block, R)
    if RB < 1 or R % RB:
        raise ValueError(f"sort_pairs: R = {R} is not a multiple of "
                         f"min(row_block, R) = {RB}")
    if keys.is_cuda:
        return bitonic_sort_cuda(keys.contiguous(), vals.contiguous())
    return bitonic_sort_plain(keys, vals)
