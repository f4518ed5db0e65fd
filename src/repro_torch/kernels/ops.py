"""The kernel-dispatch surface of the index hot path (port of
``repro/kernels/ops.py``).

Every routed op body calls THESE functions — ``probe`` / ``search`` /
``range_query`` / ``merge`` / ``backup_probe`` / ``group_probe`` — never
a kernel directly.  Each takes the
HiStoreConfig and routes by the device of the tensors it is given:

  * a CUDA tensor launches the hand-written CUDA kernel
    (``kernels/csrc``), or raises — there is no fallback;
  * a CPU tensor takes the plain PyTorch version in
    ``core/hash_index.py`` / ``core/sorted_index.py`` (the backup and
    group probes', ``backup_probe_plain`` and ``group_probe_plain``, are
    here).

``cfg.use_kernels`` keeps its values so configs compare field for field
with the JAX package: "on" and "auto" allow the routing above, "off"
makes a CUDA tensor raise rather than run the card on the plain path.
Both routes are bit-exact with the JAX kernels (the JAX package's
dispatch contract).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current
stream, raises on a nonzero launch status, and adds one to
``LAUNCHES[name]`` per launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hash_index as hix
from repro_torch.core import log as lg
from repro_torch.core import sorted_index as six
from repro_torch.core.hashing import I32

# launches of each CUDA kernel in this process (reset by callers that
# count the launches of one run)
LAUNCHES = {"hash_probe": 0, "sorted_search": 0, "merge": 0,
            "backup_probe": 0, "group_probe": 0}


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


def _c(lib: str, fn: str):
    """The C entry point ``fn`` of kernel library ``lib`` (built on first
    use)."""
    from repro_torch.kernels import _build

    return getattr(_build.lib(lib), fn)


def _raise_on(status: int, kernel: str):
    if status != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {status}")


# ---------------------------------------------------------------------------
# the CUDA wrappers
# ---------------------------------------------------------------------------
def hash_probe_cuda(bucket, qsig, qfp, sig, fp, addr, fill,
                    slots_per_bucket: int):
    """bucket/qsig/qfp: [Q] int32 descriptors; sig/fp/addr: [nb, CS]
    int32; fill: [nb] int32.  Returns (addr, found int32, n_accesses)."""
    for n, t in (("bucket", bucket), ("qsig", qsig), ("qfp", qfp),
                 ("fill", fill)):
        _check(n, t, I32)
    for n, t in (("sig", sig), ("fp", fp), ("addr", addr)):
        _check(n, t, I32, 2)
    Q = bucket.shape[0]
    nb, cs = sig.shape
    if (qsig.shape[0] != Q or qfp.shape[0] != Q or fp.shape != sig.shape
            or addr.shape != sig.shape or fill.shape[0] != nb):
        raise ValueError("hash_probe: inconsistent shapes")
    out = torch.empty((3, Q), dtype=I32, device=bucket.device)
    with torch.cuda.device(bucket.device):
        st = _c("hash_probe", "histore_hash_probe")(
            bucket.data_ptr(), qsig.data_ptr(), qfp.data_ptr(),
            sig.data_ptr(), fp.data_ptr(), addr.data_ptr(), fill.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            Q, cs, slots_per_bucket, _stream(bucket))
    _raise_on(st, "hash_probe")
    LAUNCHES["hash_probe"] += 1
    return out[0], out[1], out[2]


def sorted_search_cuda(queries, keys, addrs, fanout: int):
    """queries: [Q] int32; keys/addrs: [cap] int32 (ascending,
    INF-padded).  Returns (addr, found int32, n_accesses, pos,
    lower_bound), each [Q] int32."""
    for n, t in (("queries", queries), ("keys", keys), ("addrs", addrs)):
        _check(n, t, I32)
    cap = keys.shape[0]
    if addrs.shape[0] != cap or cap < 1:
        raise ValueError("sorted_search: inconsistent shapes")
    Q = queries.shape[0]
    levels = six.directory_levels(cap, fanout)
    out = torch.empty((5, Q), dtype=I32, device=queries.device)
    with torch.cuda.device(queries.device):
        st = _c("sorted_search", "histore_sorted_search")(
            queries.data_ptr(), keys.data_ptr(), addrs.data_ptr(),
            *[out[i].data_ptr() for i in range(5)], Q, cap, fanout, levels,
            _stream(queries))
    _raise_on(st, "sorted_search")
    LAUNCHES["sorted_search"] += 1
    return tuple(out[i] for i in range(5))


MERGE_MAX_BATCH = 16384


def merge_cuda(ekeys, eaddrs, bkeys, baddrs, bops):
    """ekeys/eaddrs: [cap] int32 (ascending, INF-padded); bkeys/baddrs/
    bops: [m] int32 log batch (op 0 invalid / 1 PUT / 2 DEL).  Returns
    (new_keys [cap], new_addrs [cap], size [1])."""
    for n, t in (("ekeys", ekeys), ("eaddrs", eaddrs), ("bkeys", bkeys),
                 ("baddrs", baddrs), ("bops", bops)):
        _check(n, t, I32)
    cap = ekeys.shape[0]
    m = bkeys.shape[0]
    if (eaddrs.shape[0] != cap or baddrs.shape[0] != m
            or bops.shape[0] != m or cap < 1 or m < 1):
        raise ValueError("merge: inconsistent shapes")
    MP = 1
    while MP < m:
        MP <<= 1
    if MP > MERGE_MAX_BATCH:
        raise ValueError(f"merge: batch of {m} pads to {MP} > "
                         f"{MERGE_MAX_BATCH} (the sort's shared memory)")
    dev = ekeys.device
    nbytes = _c("merge", "histore_merge_scratch_bytes")(cap, MP)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    nk = torch.empty((cap,), dtype=I32, device=dev)
    na = torch.empty((cap,), dtype=I32, device=dev)
    size = torch.empty((1,), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        st = _c("merge", "histore_merge")(
            ekeys.data_ptr(), eaddrs.data_ptr(), bkeys.data_ptr(),
            baddrs.data_ptr(), bops.data_ptr(), nk.data_ptr(), na.data_ptr(),
            size.data_ptr(), scratch.data_ptr(), cap, m, MP, _stream(ekeys))
    _raise_on(st, "merge")
    LAUNCHES["merge"] += 1
    return nk, na, size


BACKUP_MAX_REPLICAS = 8


def _replica_ptrs(kernel, sorted_r, blogs_r):
    """(R, cap, lcap, host array of the 7 R device pointers) of the R
    replica and log states the backup and group probes take."""
    R = len(sorted_r)
    if R < 1 or R > BACKUP_MAX_REPLICAS or len(blogs_r) != R:
        raise ValueError(f"{kernel}: 1..{BACKUP_MAX_REPLICAS} replicas "
                         f"with one log each, got {R} and {len(blogs_r)}")
    cap = sorted_r[0].keys.shape[0]
    lcap = blogs_r[0].keys.shape[0]
    if cap < 1 or lcap < 1:
        raise ValueError(f"{kernel}: empty replica or log")
    ptrs = []
    for srt, blog in zip(sorted_r, blogs_r):
        for n, t, dtype, shape in (
                ("sorted keys", srt.keys, I32, (cap,)),
                ("sorted addrs", srt.addrs, I32, (cap,)),
                ("log keys", blog.keys, I32, (lcap,)),
                ("log addrs", blog.addrs, I32, (lcap,)),
                ("log ops", blog.ops, torch.int8, (lcap,)),
                ("log applied", blog.applied, I32, ()),
                ("log tail", blog.tail, I32, ())):
            _check(n, t, dtype, len(shape))
            if tuple(t.shape) != shape:
                raise ValueError(f"{kernel}: {n} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            ptrs.append(t.data_ptr())
    return R, cap, lcap, (ctypes.c_void_p * len(ptrs))(*ptrs)


def backup_probe_cuda(keys, rep_sel, sorted_r, blogs_r, fanout: int):
    """keys: [Q] int32; rep_sel: [Q, R] int32; sorted_r / blogs_r: R
    SortedIndex / UpdateLog states (keys and addrs int32, ops int8,
    applied and tail 0-d int32 on the card, read there).  One call takes
    the R pointer sets: nothing is stacked.  Returns (addr, found int32,
    n_accesses), each [Q] int32."""
    _check("keys", keys, I32)
    _check("rep_sel", rep_sel, I32, 2)
    R, cap, lcap, host_ptrs = _replica_ptrs("backup_probe", sorted_r,
                                            blogs_r)
    Q = keys.shape[0]
    if rep_sel.shape != (Q, R):
        raise ValueError("backup_probe: inconsistent shapes")
    levels = six.directory_levels(cap, fanout)
    out = torch.empty((4, Q), dtype=I32, device=keys.device)
    with torch.cuda.device(keys.device):
        st = _c("backup_probe", "histore_backup_probe")(
            keys.data_ptr(), rep_sel.data_ptr(),
            ctypes.cast(host_ptrs, ctypes.c_void_p),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), Q, R, cap, lcap, fanout, levels,
            _stream(keys))
    _raise_on(st, "backup_probe")
    LAUNCHES["backup_probe"] += 1
    return out[0], out[1], out[2]


def group_probe_cuda(bucket, qsig, qfp, rkeys, rep_sel, sig, fp, addr, fill,
                     sorted_r, blogs_r, slots_per_bucket: int, fanout: int):
    """The fused GET probe of one group.  bucket/qsig/qfp/rkeys: [Q]
    int32 (hash descriptors and raw keys); rep_sel: [Q, R] int32;
    sig/fp/addr: [nb, CS] int32 and fill: [nb] int32 (the hash table);
    sorted_r / blogs_r: the R replica and log states the device holds
    (as backup_probe_cuda takes them).  Returns (h_addr, h_found,
    h_acc, b_addr, b_found, b_acc), each [Q] int32."""
    for n, t in (("bucket", bucket), ("qsig", qsig), ("qfp", qfp),
                 ("rkeys", rkeys), ("fill", fill)):
        _check(n, t, I32)
    for n, t in (("sig", sig), ("fp", fp), ("addr", addr)):
        _check(n, t, I32, 2)
    _check("rep_sel", rep_sel, I32, 2)
    R, cap, lcap, host_ptrs = _replica_ptrs("group_probe", sorted_r,
                                            blogs_r)
    Q = bucket.shape[0]
    nb, cs = sig.shape
    if (qsig.shape[0] != Q or qfp.shape[0] != Q or rkeys.shape[0] != Q
            or rep_sel.shape != (Q, R) or fp.shape != sig.shape
            or addr.shape != sig.shape or fill.shape[0] != nb):
        raise ValueError("group_probe: inconsistent shapes")
    levels = six.directory_levels(cap, fanout)
    out = torch.empty((7, Q), dtype=I32, device=bucket.device)
    with torch.cuda.device(bucket.device):
        st = _c("group_probe", "histore_group_probe")(
            bucket.data_ptr(), qsig.data_ptr(), qfp.data_ptr(),
            rkeys.data_ptr(), rep_sel.data_ptr(), sig.data_ptr(),
            fp.data_ptr(), addr.data_ptr(), fill.data_ptr(),
            ctypes.cast(host_ptrs, ctypes.c_void_p),
            *[out[i].data_ptr() for i in range(7)], Q, cs,
            slots_per_bucket, R, cap, lcap, fanout, levels, _stream(bucket))
    _raise_on(st, "group_probe")
    LAUNCHES["group_probe"] += 1
    return tuple(out[i] for i in range(6))


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


# ---------------------------------------------------------------------------
# the routed ops
# ---------------------------------------------------------------------------
def probe(cfg, index, keys):
    """GET probe on a HashIndex -> (addr, found bool, n_accesses).
    Bit-exact with hash_index.lookup."""
    if not kernels_enabled(cfg, keys.device):
        return hix.lookup(index, keys, cfg)
    b, sig, fp = hix.descriptors(index, keys)
    addr, found, acc = hash_probe_cuda(b, sig, fp, index.sig, index.fp,
                                       index.addr, index.fill,
                                       cfg.slots_per_bucket)
    return addr, found.bool(), acc


def search(cfg, index, queries):
    """Point lookup on a SortedIndex -> (addr, found bool, n_accesses).
    Bit-exact with sorted_index.search."""
    if not kernels_enabled(cfg, queries.device):
        return six.search(index, queries, cfg.fanout)
    addr, found, acc, _, _ = sorted_search_cuda(
        queries.to(I32).contiguous(), index.keys, index.addrs, cfg.fanout)
    return addr, found.bool(), acc


def merge(cfg, index, keys, addrs, ops):
    """Apply a log batch to a SortedIndex (newest-wins, tombstones
    compact away) -> SortedIndex.  Bit-exact with sorted_index.merge."""
    if not kernels_enabled(cfg, keys.device):
        return six.merge(index, keys, addrs, ops)
    nk, na, size = merge_cuda(index.keys, index.addrs, keys.to(I32),
                              addrs.to(I32), ops.to(I32))
    return six.SortedIndex(nk, na, size[0])


def range_query(cfg, index, lo, hi, limit: int):
    """SCAN [lo, hi] -> (keys [limit], addrs [limit], count).  The lower
    bound comes from the sorted-search kernel's descent (Q = 1); the
    take/mask tail is shared with the plain path (range_from_start)."""
    if not kernels_enabled(cfg, index.keys.device):
        return six.range_query(index, lo, hi, limit)
    q = torch.as_tensor(lo, dtype=I32, device=index.keys.device).reshape(1)
    *_, lbound = sorted_search_cuda(q, index.keys, index.addrs, cfg.fanout)
    return six.range_from_start(index, lbound[0], hi, limit)


def backup_probe(cfg, sorted_r, blogs_r, keys, rep_sel):
    """Degraded lookup across the R sorted replicas and their pending
    logs, combined by ``rep_sel`` [Q, R] (later selected replicas
    overwrite earlier ones) -> (addr, found bool, n_accesses).
    Bit-exact with backup_probe_plain."""
    if not kernels_enabled(cfg, keys.device):
        return backup_probe_plain(cfg, sorted_r, blogs_r, keys, rep_sel)
    addr, found, acc = backup_probe_cuda(
        keys.to(I32).contiguous(), rep_sel.to(I32).contiguous(),
        sorted_r, blogs_r, cfg.fanout)
    return addr, found.bool(), acc


def group_probe(cfg, hidx, sorted_r, blogs_r, keys, rep_sel):
    """The fused GET probe: the hash chain walk and the replica-select
    backup probe of one group in one kernel call (the op body combines
    the pair with its own ``am_primary`` mask).  Returns (h_addr,
    h_found bool, h_acc, b_addr, b_found bool, b_acc).  Bit-exact with
    group_probe_plain."""
    if not kernels_enabled(cfg, keys.device):
        return group_probe_plain(cfg, hidx, sorted_r, blogs_r, keys, rep_sel)
    b, sig, fp = hix.descriptors(hidx, keys)
    ha, hf, hc, ba, bf, bc = group_probe_cuda(
        b, sig, fp, keys.to(I32).contiguous(), rep_sel.to(I32).contiguous(),
        hidx.sig, hidx.fp, hidx.addr, hidx.fill, sorted_r, blogs_r,
        cfg.slots_per_bucket, cfg.fanout)
    return ha, hf.bool(), hc, ba, bf.bool(), bc
