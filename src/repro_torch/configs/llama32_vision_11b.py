"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision].

Language backbone: 40 layers, d_model=4096, 32 heads GQA kv=8,
d_ff=14336, vocab 128256; every 5th layer is a gated cross-attention
layer over vision-patch embeddings. The ViT frontend is a stub
providing (B, 1601, 1280) patch embeddings (projected to d_model by
``cond_proj``). Its 9.78 B parameters hold 19.6 GB in bf16: one 80 GB
card serves it whole.
"""
from .base import LayerSpec, ModelConfig

SELF = LayerSpec(mixer="attn", mlp="dense")
CROSS = LayerSpec(mixer="cross_attn", mlp="dense")


def config() -> ModelConfig:
    # period: 4 self-attn layers then 1 cross-attn layer, x8 = 40 layers
    return ModelConfig(
        name="llama-3.2-vision-11b",
        arch_type="vlm",
        d_model=4096,
        n_layers=40,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        groups=(((SELF, SELF, SELF, SELF, CROSS), 8),),
        cond_seq_len=1601,    # stub ViT patch embeddings
        cond_dim=1280,
        rope_theta=500000.0,
    )
