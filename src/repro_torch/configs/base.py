"""Model/run configuration system (port of ``repro/configs/base.py``).

Every assigned architecture is expressed as a frozen ``ModelConfig``, with
the JAX package's fields and defaults unchanged, so two configs compare
field for field.  Per-layer *layer specs* (mixer kind, ffn kind) are
derived from the config fields; ``layer_plan`` groups repeated specs into
the stages the JAX package scans over.  The port runs its layers in a
Python loop and uses the plan only to carry stacked weights across
(``convert.py``).

Input shapes are the four assigned shape points (train_4k / prefill_32k /
decode_32k / long_500k); ``input_specs`` gives a cell's model inputs as
meta-device tensors, as the JAX package's dry run takes them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------
# A LayerSpec is (mixer, ffn):
#   mixer ∈ {"attn", "local", "mla", "mamba1", "mamba2", "mamba2+shared"}
#   ffn   ∈ {"mlp", "moe", None}
# "mamba2+shared" marks a mamba2 layer after which the *tied* shared
# attention+MLP block (Zamba2-style) is invoked.
LayerSpec = tuple[str, Optional[str]]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # layer pattern ------------------------------------------------------
    local_global_pattern: int = 0   # gemma3: N local layers per 1 global
    sliding_window: int = 0
    attn_kind: str = "attn"         # attn | mla   (mixer for attention layers)

    # MoE -----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0          # leading dense-MLP layers (DeepSeek style)
    capacity_factor: float = 1.25
    moe_impl: str = "sort"          # sort | dense  (dispatch implementation)

    # MLA -----------------------------------------------------------------
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    mla_absorb: bool = False        # decode-time absorbed projections (opt.)

    # SSM -----------------------------------------------------------------
    mamba_version: int = 0          # 0 = no ssm, 1 = mamba1, 2 = mamba2
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64          # mamba2
    ssm_groups: int = 8             # mamba2 B/C groups
    ssm_chunk: int = 128            # chunked-scan length

    # Zamba2-style shared attention block ---------------------------------
    shared_attn_every: int = 0

    # IO -------------------------------------------------------------------
    frontend: str = "token"         # token | embed (VLM/audio stubs)
    tie_embeddings: bool = False

    # misc -----------------------------------------------------------------
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # attention implementation: "flash" (blockwise online-softmax scan) or
    # "naive" (materialised scores; only for tiny smoke configs)
    attn_impl: str = "flash"
    attn_q_block: int = 512
    attn_kv_block: int = 512
    # hillclimb levers (all default to the baseline path; see EXPERIMENTS.md
    # §Perf for the measured effect of each)
    attn_block_skip: bool = False   # skip fully-masked causal kv blocks
    remat: str = "unit"             # none | unit  (checkpoint each pattern unit)
    zero1: bool = True              # shard optimizer state over data axis
    fsdp: bool = False              # additionally shard params over data axis
    decode_cache_hint: bool = False  # constrain KV cache sharding post-update
    ssm_scan_dtype: str = "float32"  # bfloat16 -> halve scan-intermediate bytes
    ssm_impl: str = "jnp"            # jnp (chunked scan) | pallas (the fused
                                     # scan kernel, kernels/mamba_scan.py)
                                     # | stub

    def with_opts(self, opts: str) -> "ModelConfig":
        """Apply 'k=v,k=v' overrides (dryrun --set); ints/floats/bools
        parsed, strings passed through."""
        if not opts:
            return self
        kw = {}
        for item in opts.split(","):
            k, v = item.split("=")
            cur = getattr(self, k)
            if isinstance(cur, bool):
                kw[k] = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                kw[k] = int(v)
            elif isinstance(cur, float):
                kw[k] = float(v)
            else:
                kw[k] = v
        return self.scaled(**kw)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def subquadratic(self) -> bool:
        """True if long-context (500k) decode is within scope: SSM/hybrid or
        mostly-local attention archs."""
        return self.mamba_version > 0 or self.local_global_pattern > 0

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_specs(self) -> list[LayerSpec]:
        specs: list[LayerSpec] = []
        for i in range(self.n_layers):
            # mixer
            if self.mamba_version == 1:
                mixer = "mamba1"
            elif self.mamba_version == 2:
                mixer = "mamba2"
                if self.shared_attn_every and (i + 1) % self.shared_attn_every == 0:
                    mixer = "mamba2+shared"
            elif self.local_global_pattern:
                p = self.local_global_pattern
                mixer = "attn" if (i % (p + 1)) == p else "local"
            else:
                mixer = self.attn_kind
            # ffn
            if self.mamba_version:  # mamba blocks are the whole layer
                ffn = None
            elif self.n_experts and i >= self.first_k_dense:
                ffn = "moe"
            else:
                ffn = "mlp"
            specs.append((mixer, ffn))
        return specs

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced config of the same family (for smoke tests)."""
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Layer plan: group the spec list into scannable stages
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Stage:
    kind: str                 # "single" | "scan"
    pattern: tuple[LayerSpec, ...]
    n_rep: int                # repeats (1 for single)


def layer_plan(cfg: ModelConfig) -> list[Stage]:
    """Decompose the layer-spec list into [leading singles] + [scanned
    pattern repeats] + [trailing singles], as the JAX package stacks its
    weights (``convert.params_from_numpy`` unstacks them)."""
    specs = cfg.layer_specs()
    stages: list[Stage] = []
    i = 0
    # leading singles (e.g. first_k_dense)
    while i < len(specs) and cfg.first_k_dense and i < cfg.first_k_dense:
        stages.append(Stage("single", (specs[i],), 1))
        i += 1
    rest = specs[i:]
    if not rest:
        return stages
    # find smallest repeating pattern length
    best = None
    for plen in range(1, min(9, len(rest) + 1)):
        pat = tuple(rest[:plen])
        reps = 1
        while (reps + 1) * plen <= len(rest) and tuple(
            rest[reps * plen:(reps + 1) * plen]) == pat:
            reps += 1
        rem = len(rest) - reps * plen
        score = rem + plen  # prefer small remainder then small pattern
        if best is None or score < best[0]:
            best = (score, pat, reps, rem)
    _, pat, reps, rem = best
    if reps > 1:
        stages.append(Stage("scan", pat, reps))
    else:
        for s in pat:
            stages.append(Stage("single", (s,), 1))
    for s in rest[reps * len(pat):]:
        stages.append(Stage("single", (s,), 1))
    return stages


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skip: pure full-attention arch; long_500k requires "
                       "sub-quadratic attention (see DESIGN.md)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-device stand-ins for every model input (no allocation), the
    JAX package's keys, shapes and dtypes.

    train/prefill: token ids (or precomputed frontend embeddings for
    vlm/audio stubs) + labels.  decode: one new token per sequence + per-seq
    position, with the KV cache handled separately.
    """
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.param_dtype

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    T = S if shape.kind in ("train", "prefill") else 1
    if cfg.frontend == "embed":
        d = {"embeds": meta((B, T, cfg.d_model), dt)}
    else:
        d = {"tokens": meta((B, T), torch.int32)}
    if shape.kind in ("train", "prefill"):
        d["targets"] = meta((B, S), torch.int32)
    else:
        d["pos"] = meta((B,), torch.int32)
    return d


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # populate the registry lazily
    if not _REGISTRY:
        from repro_torch import configs  # noqa: F401  (imports all arch modules)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> list[str]:
    if not _REGISTRY:
        from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)
