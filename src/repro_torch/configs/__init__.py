"""Model configurations of the port: EMSNet (``emsnet``,
``get_emsnet_config(**kw)``) and the LLM zoo's registry,
``get_config(arch_id)``.

The registry names the reference's ten architectures: dense GQA
(Mistral-NeMo, CodeQwen1.5, Nemotron-4, Qwen1.5), RWKV6, MoE (OLMoE),
the Mamba/attention hybrid (Jamba), MLA with MoE (DeepSeek-V3), gated
cross-attention over image patches (Llama-3.2-Vision) and the
multi-codebook decoder with a conditioning sublayer (MusicGen).
"""
from . import (codeqwen15_7b, deepseek_v3_671b, emsnet, jamba_v01_52b,
               llama32_vision_11b, mistral_nemo_12b, musicgen_large,
               nemotron_4_15b, olmoe_1b_7b, qwen15_32b, rwkv6_1b6)
from .base import (SHAPES, InputShape, LayerSpec,  # noqa: F401
                   MambaConfig, MLAConfig, ModelConfig, reduced)

_REGISTRY = {
    "mistral-nemo-12b": mistral_nemo_12b.config,
    "rwkv6-1.6b": rwkv6_1b6.config,
    "olmoe-1b-7b": olmoe_1b_7b.config,
    "codeqwen1.5-7b": codeqwen15_7b.config,
    "nemotron-4-15b": nemotron_4_15b.config,
    "qwen1.5-32b": qwen15_32b.config,
    "jamba-v0.1-52b": jamba_v01_52b.config,
    "deepseek-v3-671b": deepseek_v3_671b.config,
    "llama-3.2-vision-11b": llama32_vision_11b.config,
    "musicgen-large": musicgen_large.config,
}

ARCHS = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return _REGISTRY[name]()


def get_emsnet_config(**kw):
    return emsnet.config(**kw)
