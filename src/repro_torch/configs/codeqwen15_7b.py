"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B].

Qwen1.5 architecture: 32 layers, d_model=4096, 32 heads (MHA kv=32),
d_ff=13440, vocab 92416, QKV bias, SwiGLU, RoPE theta 1e6.
"""
from .base import LayerSpec, ModelConfig

L = LayerSpec(mixer="attn", mlp="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        arch_type="dense",
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab_size=92416,
        groups=(((L,), 32),),
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
