"""MusicGen-large [arXiv:2306.05284].

Decoder-only transformer over EnCodec tokens: 48 layers, d_model=2048,
32 heads (MHA), d_ff=8192, 4 codebooks x vocab 2048 (delay interleaving
pattern), cross-attention to text-conditioning embeddings in every
layer (T5 frontend is a stub providing precomputed embeddings). The
parameter tree holds 4.06 B (8.1 GB bf16); ``param_count()`` says 3.81 B,
the reference's formula, which counts the conditioning sublayer's wk/wv
as cond_dim x kv_dim where ``cond_proj`` makes their input d_model wide.
"""
from .base import LayerSpec, ModelConfig

L = LayerSpec(mixer="attn", mlp="dense", cross=True)


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        arch_type="audio",
        d_model=2048,
        n_layers=48,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        groups=(((L,), 48),),
        n_codebooks=4,
        cond_seq_len=64,      # stub: T5 text-conditioning tokens
        cond_dim=768,
        rope_theta=10000.0,
    )
