"""The port's serving cache policy (``repro_torch.serving.kv_cache``)
against the JAX package's ``repro.serving.kv_cache``: the same
``(cache_len, window_attn)`` plan for every architecture of the
reference's registry at every input shape of ``SHAPES``, and the same
mixer and window decisions, each side planning its own config."""
import dataclasses

import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.serving import kv_cache as JK
from repro_torch.configs import SHAPES, get_config
from repro_torch.serving import kv_cache as K

MIXERS = ("attn", "mla", "mamba", "rwkv6", "cross_attn")


def test_shapes_and_policy_constants_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert K.FULL_ATTN_LONG == JK.FULL_ATTN_LONG


@pytest.mark.parametrize("shape", sorted(JSHAPES))
@pytest.mark.parametrize("arch", JARCHS)
def test_cache_plan_matches_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert K.cache_plan(cfg, SHAPES[shape]) == JK.cache_plan(jcfg, JSHAPES[shape])
    assert K.uses_window(cfg, SHAPES[shape]) == \
        JK.uses_window(jcfg, JSHAPES[shape])


@pytest.mark.parametrize("arch", JARCHS)
def test_has_mixer_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert [K.has_mixer(cfg, m) for m in MIXERS] == \
        [JK.has_mixer(jcfg, m) for m in MIXERS]


def test_long_context_plans():
    """At long_500k a GQA arch decodes over its sliding window, the
    hybrid keeps its full cache, MLA and the recurrent archs have no
    plain attention to window; every other shape decodes over a full
    cache of its length."""
    long = SHAPES["long_500k"]
    assert K.cache_plan(get_config("mistral-nemo-12b"), long) == (8192, 8192)
    assert K.cache_plan(get_config("jamba-v0.1-52b"), long) == (524288, 0)
    assert K.cache_plan(get_config("deepseek-v3-671b"), long) == (524288, 0)
    assert K.cache_plan(get_config("rwkv6-1.6b"), long) == (524288, 0)
    assert K.cache_plan(get_config("qwen1.5-32b"), SHAPES["decode_32k"]) == \
        (32768, 0)
