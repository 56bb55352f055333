"""Config system of the LLM zoo: architecture configs, input shapes,
reduced (smoke) variants.

The port's own copy of ``repro.configs.base`` (plain dataclasses, no
JAX): the same fields, defaults, ``q_dim``/``kv_dim``,
``param_count``/``active_param_count`` and the same ``reduced()``, so a
config built here describes exactly the model the reference builds. Every ported architecture has one
``<id>.py`` in this package with the published dimensions (source cited
in its header). ``reduced()`` derives the CPU-smoke variant (one period
per group, d_model<=512, <=4 experts) while keeping the layer-group
*structure* of the family.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims [arXiv:2412.19437]."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM dims (Jamba uses these) [arXiv:2403.19887]."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclass(frozen=True)
class LayerSpec:
    """One layer position inside a repeating period.

    mixer: 'attn' | 'mla' | 'mamba' | 'rwkv6' | 'cross_attn'
    mlp:   'dense' | 'moe' | 'rwkv_cmix' | 'none'
    cross: if True, an additional cross-attention sublayer runs after the
           self mixer (musicgen-style conditioning).
    window: sliding-window size for this layer's self attention
            (0 = full causal).
    """
    mixer: str = "attn"
    mlp: str = "dense"
    cross: bool = False
    window: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense|moe|ssm|hybrid|vlm|audio
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # repeating layer structure: ((period_specs, repeat_count), ...)
    # n_layers == sum(len(period) * count)
    groups: tuple = ()
    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # --- attention details ---
    mlp_act: str = "swiglu"             # swiglu | relu2
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv_head_dim: int = 64
    # --- modality frontend stubs ---
    cond_seq_len: int = 0               # vision patches / conditioning tokens
    cond_dim: int = 0                   # frontend embedding dim
    n_codebooks: int = 1                # musicgen EnCodec codebooks
    # --- extras ---
    mtp: bool = False                   # DeepSeek multi-token prediction
    long_context_window: int = 8192     # sliding window used for long_500k
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # --- training / distribution policy ---
    fsdp_weights: bool = True
    remat: bool = True
    train_microbatches: int = 4
    optimizer: str = "adafactor"

    def __post_init__(self):
        if self.groups:
            n = sum(len(specs) * count for specs, count in self.groups)
            if n != self.n_layers:
                raise ValueError(
                    f"{self.name}: groups cover {n} layers != n_layers={self.n_layers}")

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d = self.d_model
        total = self.vocab_size * d * self.n_codebooks          # embed
        if not self.tie_embeddings:
            total += d * self.vocab_size * self.n_codebooks     # lm head
        for specs, count in self.groups:
            per = 0
            for s in specs:
                per += _mixer_params(self, s)
                per += _mlp_params(self, s)
                per += 2 * d                                     # norms
            total += per * count
        if self.cond_dim:
            total += self.cond_dim * d                           # projector
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE: only top-k experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        # subtract inactive routed experts
        for specs, count in self.groups:
            for s in specs:
                if s.mlp == "moe":
                    inactive = self.n_experts - self.experts_per_tok
                    total -= count * inactive * 3 * d * self.moe_d_ff
        return total


def _mixer_params(cfg: ModelConfig, s: LayerSpec) -> int:
    d = cfg.d_model
    if s.mixer == "attn" or s.mixer == "cross_attn":
        n = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
        if s.cross:
            n += d * cfg.q_dim + 2 * cfg.cond_dim * cfg.kv_dim + cfg.q_dim * d
        return n
    if s.mixer == "mla":
        m = cfg.mla
        qh = cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
        return (d * m.q_lora_rank + m.q_lora_rank * qh
                + d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_dim)
                + cfg.n_heads * m.v_dim * d)
    if s.mixer == "mamba":
        di = cfg.mamba.d_inner(d)
        st = cfg.mamba.d_state
        dtr = max(d // 16, 1)
        return (d * 2 * di + di * cfg.mamba.d_conv + di * (dtr + 2 * st)
                + dtr * di + di * st + di + di * d)
    if s.mixer == "rwkv6":
        return 4 * d * d + d * d + 2 * d * 64  # r,k,v,g,o + w lora
    raise ValueError(s.mixer)


def _mlp_params(cfg: ModelConfig, s: LayerSpec) -> int:
    d = cfg.d_model
    if s.mlp == "dense":
        mult = 3 if cfg.mlp_act == "swiglu" else 2
        return mult * d * cfg.d_ff
    if s.mlp == "moe":
        n = cfg.n_experts * 3 * d * cfg.moe_d_ff + d * cfg.n_experts
        n += cfg.n_shared_experts * 3 * d * cfg.moe_d_ff
        return n
    if s.mlp == "rwkv_cmix":
        return 2 * d * cfg.d_ff
    return 0


# ----------------------------------------------------------------------
# Input shapes (assigned)
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, *, d_model: int = 128, seq_cap: int = 64) -> ModelConfig:
    """Smoke-test variant: same family structure, tiny dims.

    Keeps one period per group with count 1 (so every layer *kind* in the
    family is exercised) and scales every dimension down.
    """
    del seq_cap
    scale = d_model / cfg.d_model
    groups = tuple((specs, 1) for specs, _ in cfg.groups)
    n_layers = sum(len(specs) for specs, _ in groups)
    n_heads = max(2, min(4, cfg.n_heads))
    head_dim = max(8, d_model // n_heads)
    n_kv = n_heads if cfg.n_kv_heads == cfg.n_heads else max(1, n_heads // 2)
    n_experts = min(cfg.n_experts, 4) if cfg.n_experts else 0
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                        qk_rope_dim=8, v_dim=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        d_model=d_model,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=max(32, int(math.ceil(cfg.d_ff * scale / 16) * 16)),
        vocab_size=min(cfg.vocab_size, 512),
        groups=groups,
        n_experts=n_experts,
        experts_per_tok=min(cfg.experts_per_tok, 2) if n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_d_ff=max(16, int(cfg.moe_d_ff * scale)) if cfg.n_experts else 0,
        mla=mla,
        cond_seq_len=min(cfg.cond_seq_len, 8),
        cond_dim=min(cfg.cond_dim, 32) if cfg.cond_dim else 0,
        long_context_window=128,
        dtype="float32",
        fsdp_weights=False,
        remat=False,
        train_microbatches=1,
        optimizer="adamw",
        capacity_factor=2.0,
    )
