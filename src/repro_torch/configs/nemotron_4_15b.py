"""Nemotron-4 15B [arXiv:2402.16819].

32 layers, d_model=6144, 48 heads, GQA kv=8, d_ff=24576 (squared-ReLU,
no gate), vocab 256000, RoPE.
"""
from .base import LayerSpec, ModelConfig

L = LayerSpec(mixer="attn", mlp="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        arch_type="dense",
        d_model=6144,
        n_layers=32,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        groups=(((L,), 32),),
        mlp_act="relu2",
        rope_theta=10000.0,
    )
