"""Model configurations of the port: EMSNet (``emsnet``,
``get_emsnet_config(**kw)``) and the LLM zoo's registry,
``get_config(arch_id)``.

The registry names only the architectures the port serves: dense GQA
(Mistral-NeMo, CodeQwen1.5, Nemotron-4, Qwen1.5), RWKV6 and MoE
(OLMoE). The JAX package's other architectures (MLA, Mamba,
cross-attention, musicgen codebooks) are known by name and refused with
an error that points at ROADMAP item 11, where they are queued.
"""
from . import (codeqwen15_7b, emsnet, mistral_nemo_12b, nemotron_4_15b,
               olmoe_1b_7b, qwen15_32b, rwkv6_1b6)
from .base import (SHAPES, InputShape, LayerSpec,  # noqa: F401
                   MambaConfig, MLAConfig, ModelConfig, reduced)

_REGISTRY = {
    "mistral-nemo-12b": mistral_nemo_12b.config,
    "rwkv6-1.6b": rwkv6_1b6.config,
    "olmoe-1b-7b": olmoe_1b_7b.config,
    "codeqwen1.5-7b": codeqwen15_7b.config,
    "nemotron-4-15b": nemotron_4_15b.config,
    "qwen1.5-32b": qwen15_32b.config,
}

ARCHS = tuple(_REGISTRY)

# the reference's other architectures, still to port
NOT_PORTED = ("deepseek-v3-671b", "musicgen-large", "llama-3.2-vision-11b",
              "jamba-v0.1-52b")


def get_config(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP item 11); the port "
            f"serves {ARCHS}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return _REGISTRY[name]()


def get_emsnet_config(**kw):
    return emsnet.config(**kw)
