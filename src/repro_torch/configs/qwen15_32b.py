"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family card].

64 layers, d_model=5120, 40 heads GQA kv=40 (MHA per assignment),
d_ff=27392, vocab 152064, QKV bias, SwiGLU.
"""
from .base import LayerSpec, ModelConfig

L = LayerSpec(mixer="attn", mlp="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        arch_type="dense",
        d_model=5120,
        n_layers=64,
        n_heads=40,
        n_kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab_size=152064,
        groups=(((L,), 64),),
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
