"""OLMoE-1B-7B [arXiv:2409.02060].

16 layers, d_model=2048, 16 heads (MHA kv=16), MoE with 64 experts
top-8, expert d_ff=1024, vocab 50304.
"""
from .base import LayerSpec, ModelConfig

L = LayerSpec(mixer="attn", mlp="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        arch_type="moe",
        d_model=2048,
        n_layers=16,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab_size=50304,
        groups=(((L,), 16),),
        n_experts=64,
        experts_per_tok=8,
        moe_d_ff=1024,
        rope_theta=10000.0,
        fsdp_weights=False,   # 7B total fits without FSDP
        optimizer="adamw",
    )
