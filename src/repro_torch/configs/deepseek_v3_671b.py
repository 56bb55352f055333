"""DeepSeek-V3 671B [arXiv:2412.19437].

61 layers, d_model=7168, 128 heads, MLA (q_lora 1536 / kv_lora 512,
nope 128 + rope 64, v 128), first 3 layers dense FFN (d_ff 18432), the
remaining 58 layers MoE with 1 shared + 256 routed experts, top-8,
expert d_ff 2048, vocab 129280, MTP head.

The assignment line "d_ff=2048" is the routed-expert intermediate size;
the dense layers use the published 18432.
"""
from .base import LayerSpec, MLAConfig, ModelConfig

DENSE = LayerSpec(mixer="mla", mlp="dense")
MOE = LayerSpec(mixer="mla", mlp="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        d_model=7168,
        n_layers=61,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=18432,
        vocab_size=129280,
        groups=(((DENSE,), 3), ((MOE,), 58)),
        n_experts=256,
        experts_per_tok=8,
        n_shared_experts=1,
        moe_d_ff=2048,
        mla=MLAConfig(),
        rope_theta=10000.0,
        mtp=True,
        train_microbatches=8,
    )
