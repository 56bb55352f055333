"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892].

24 layers, d_model=2048, attention-free time-mix with data-dependent
decay (64-dim heads -> 32 heads), channel-mix d_ff=7168 (relu^2),
vocab 65536. Constant-size recurrent state per layer: (32, 64, 64)
float32 plus the two token-shift rows.
"""
from .base import LayerSpec, ModelConfig

L = LayerSpec(mixer="rwkv6", mlp="rwkv_cmix")


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        arch_type="ssm",
        d_model=2048,
        n_layers=24,
        n_heads=32,           # d_model / rwkv_head_dim
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        groups=(((L,), 24),),
        rwkv_head_dim=64,
        fsdp_weights=False,
        optimizer="adamw",
    )
