"""Mistral-Nemo-Base-2407 12B [hf:mistralai/Mistral-Nemo-Base-2407].

40 layers, d_model=5120, 32 heads GQA kv=8, head_dim=128, d_ff=14336,
vocab 131072, 128k context (rope theta 1e6). Note q_dim = 32 x 128 =
4096 != d_model: wq is (5120, 4096) and wo (4096, 5120).
"""
from .base import LayerSpec, ModelConfig

L = LayerSpec(mixer="attn", mlp="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        arch_type="dense",
        d_model=5120,
        n_layers=40,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        groups=(((L,), 40),),
        rope_theta=1_000_000.0,
    )
