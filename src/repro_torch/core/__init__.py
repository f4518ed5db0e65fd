"""HiStore core in PyTorch: hybrid index (hash table + sorted index).

Modules (the same names as the JAX package's ``core``):
  hashing       — 32-bit key mixing (shared with the CUDA kernels)
  hash_index    — chained bucket hash table (primary index)
  sorted_index  — hierarchical-directory sorted array
  log           — append-only update log with an applied prefix
  index_group   — 1 hash + N sorted replicas + logs, failure/recovery
  data_plane    — the value plane: slot allocator, mirrors, free queues
  comm          — the store's collectives over W ranks (one process: none)
  verbs         — the RDMA verbs over G groups (stacked on one device, or
                  G / W a rank through comm)
  kvstore       — the distributed store over G index groups
  dist_selftest — the distributed protocol battery over W ranks
  tree          — NamedTuple states stacked along [G] / [R, G] axes
  client        — HiStoreClient over LocalBackend / DistributedBackend
  results       — PutResult/GetResult/DeleteResult/ScanResult,
                  FailResult/RecoverResult

Nothing is imported here, so ``import repro_torch.core.hashing`` pulls
in only what it needs.
"""
