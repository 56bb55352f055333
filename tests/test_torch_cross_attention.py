"""The port's cross-attention (``repro_torch.models.attention.cross_kv``
and ``cross_attn_forward``; Llama-3.2-Vision's gated layers and
MusicGen's conditioning sublayer) against the JAX package on the CPU.

Weights come from the reference's ``attn_init(cross=True)`` and are
converted through ``repro_torch.convert``; inputs are numpy arrays from
a seed. float32 at 1e-5, the whole-model tolerance of
``tests/test_torch_llm.py``. The configs are the reduced ones (d_model
128, ``cond_seq_len`` 8): Llama-Vision's GQA heads (4 over 2) and
MusicGen's MHA (4 over 4). The whole models, their caches and the
server are ``tests/test_torch_llm.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as A
from repro_torch.models import transformer as T

ATOL = 1e-5
CROSS_ARCHS = ("llama-3.2-vision-11b", "musicgen-large")


def _cfgs(arch, **kw):
    return (dataclasses.replace(jreduced(jget_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module", params=CROSS_ARCHS)
def cross(request):
    jcfg, cfg = _cfgs(request.param)
    jp = JA.attn_init(jax.random.PRNGKey(1), jcfg, cross=True)
    return jcfg, cfg, jp, from_jax_numpy(jax.device_get(jp), "cpu")


def test_cross_kv_matches_reference(cross):
    """Conditioning features (B=2, Cs=8, d) projected once: k and v each
    (B, Cs, KV, D)."""
    jcfg, cfg, jp, p = cross
    cond = _normal(2, 2, cfg.cond_seq_len, cfg.d_model)
    jk, jv = JA.cross_kv(jp, jnp.asarray(cond), jcfg)
    k, v = A.cross_kv(p, torch.from_numpy(cond), cfg)
    assert k.shape == v.shape == (2, cfg.cond_seq_len, cfg.n_kv_heads,
                                  cfg.head_dim)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("S", [1, 7])
def test_cross_attn_forward_matches_reference(cross, S):
    """Every query (a 7-token prefill or a 1-token decode step) attends
    to every conditioning position: the same output as the reference's
    blocked plain attention, given the same (k, v)."""
    jcfg, cfg, jp, p = cross
    x = _normal(3 + S, 2, S, cfg.d_model)
    cond = _normal(4, 2, cfg.cond_seq_len, cfg.d_model)
    jkv = JA.cross_kv(jp, jnp.asarray(cond), jcfg)
    kv = tuple(torch.from_numpy(np.array(a)) for a in jkv)
    want = JA.cross_attn_forward(jp, jnp.asarray(x), jkv, jcfg)
    got = A.cross_attn_forward(p, torch.from_numpy(x), kv, cfg)
    assert got.shape == (2, S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cross_attention_ignores_order(cross):
    """Cross attention over conditioning is permutation-equivariant in
    kv (``tests/test_attention.py::test_cross_attention_ignores_order``
    on the port)."""
    _, cfg, _, p = cross
    x = torch.from_numpy(_normal(5, 1, 4, cfg.d_model))
    cond = torch.from_numpy(_normal(6, 1, 6, cfg.d_model))
    kv = A.cross_kv(p, cond, cfg)
    out1 = A.cross_attn_forward(p, x, kv, cfg)
    perm = torch.tensor([3, 1, 0, 2, 5, 4])
    out2 = A.cross_attn_forward(p, x, (kv[0][:, perm], kv[1][:, perm]), cfg)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=ATOL)


def test_cross_projections_have_no_bias():
    """On a QKV-bias config (Qwen1.5) a cross projection drops the bias,
    as the reference's ``attn_init(cross=True)``; self-attention keeps
    it."""
    jcfg, cfg = _cfgs("qwen1.5-32b")
    for is_cross in (False, True):
        jp = JA.attn_init(jax.random.PRNGKey(0), jcfg, cross=is_cross)
        p = A.attn_init(torch.Generator().manual_seed(0), cfg, cross=is_cross,
                        device="cpu")
        assert {k: set(v) for k, v in p.items()} == \
            {k: set(v) for k, v in jp.items()}
        assert ("b" in p["wk"]) == (not is_cross)


def test_cross_attention_launches_no_kernel(cross):
    """The reference's cross-attention always runs its plain attention
    and takes no kernel switch, so the port's calls neither the flash
    nor the decode-attention wrapper, on prefill-sized and decode-sized
    queries alike."""
    _, cfg, _, p = cross
    before = (FA.flash_attention.calls, DA.decode_attention.calls)
    kv = A.cross_kv(p, torch.from_numpy(_normal(7, 1, 8, cfg.d_model)), cfg)
    for S in (5, 1):
        A.cross_attn_forward(p, torch.from_numpy(_normal(S, 1, S, cfg.d_model)),
                             kv, cfg)
    assert (FA.flash_attention.calls, DA.decode_attention.calls) == before


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_decode_reads_the_conditioning_cache_in_place(arch):
    """Prefill fills the ``cross`` (Llama-Vision) or ``cond`` (MusicGen)
    leaves; decode steps read them and write them not at all: the same
    tensors, the same bytes, so a captured decode graph reads them where
    they lie."""
    _, cfg = _cfgs(arch)
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaf = "cross" if arch.startswith("llama") else "cond"
    tokens = torch.randint(0, cfg.vocab_size, (1, 6) + (
        (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()),
        generator=torch.Generator().manual_seed(1))
    cond = torch.from_numpy(_normal(8, 1, cfg.cond_seq_len, cfg.cond_dim))
    _, cache = T.prefill(p, cfg, tokens, cond=cond, cache_len=8)
    layer = "4" if leaf == "cross" else "0"
    held = cache["0"][layer][leaf]
    before = {k: (v.data_ptr(), v.clone()) for k, v in held.items()}
    assert held["k"].shape == (1, 1, cfg.cond_seq_len, cfg.n_kv_heads,
                               cfg.head_dim)
    for t in (6, 7):
        _, out = T.decode_step(p, cfg, tokens[:, :1], cache, t)
        assert out is cache
    for k, (ptr, val) in before.items():
        assert cache["0"][layer][leaf][k].data_ptr() == ptr
        assert torch.equal(cache["0"][layer][leaf][k], val)


def test_gate_at_init_shuts_the_image_out():
    """Llama-Vision's ``gate_attn`` starts at 0, as the reference's: a
    freshly initialised model's logits do not depend on the image, which
    is why every parity test and chip run sets the gate nonzero."""
    jcfg, cfg = _cfgs("llama-3.2-vision-11b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    assert p["groups"]["0"]["4"]["gate_attn"].dtype == torch.float32
    assert not p["groups"]["0"]["4"]["gate_attn"].any()
    tokens = torch.arange(1, 7)[None]
    logits = [T.prefill(p, cfg, tokens, cond=torch.from_numpy(
        _normal(s, 1, cfg.cond_seq_len, cfg.cond_dim)))[0] for s in (9, 10)]
    assert torch.equal(*logits)
