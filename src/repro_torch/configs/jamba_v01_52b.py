"""Jamba-v0.1 52B [arXiv:2403.19887].

32 layers, d_model=4096, hybrid Mamba+attention with a 1:7
attention:mamba ratio (one attention layer per 8-layer period), GQA
kv=8 on the attention layers, MoE (16 experts top-2, expert d_ff 14336)
on every other layer, vocab 65536.
"""
from .base import LayerSpec, MambaConfig, ModelConfig

M_D = LayerSpec(mixer="mamba", mlp="dense")
M_E = LayerSpec(mixer="mamba", mlp="moe")
A_E = LayerSpec(mixer="attn", mlp="moe")


def config() -> ModelConfig:
    # 8-layer period: mamba at 0-3,5-7 / attention at 4; MoE on odd layers.
    period = (M_D, M_E, M_D, M_E, A_E, M_D, M_E, M_D)
    return ModelConfig(
        name="jamba-v0.1-52b",
        arch_type="hybrid",
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        groups=((period, 4),),
        n_experts=16,
        experts_per_tok=2,
        moe_d_ff=14336,
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        rope_theta=10000.0,
    )
