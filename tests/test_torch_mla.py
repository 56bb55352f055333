"""The port's multi-head latent attention (DeepSeek-V3's MLA,
``repro_torch.models.attention.mla_*``) against the JAX package on the
CPU.

Weights come from the reference's ``mla_init`` and are converted through
``repro_torch.convert``; inputs are numpy arrays from a seed. float32 at
the reference's own tolerances (``tests/test_attention.py``): the plain
attention with a value head dim other than the query's at 2e-5, the
forward and the absorbed decode at 1e-5 against the reference's and at
1e-4 against the port's own forward (decode's float32 latent-space
products sum in another order than the decompressed prefill's).
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
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as A

ATOL = 1e-5


def _cfgs(dtype="float32", d_model=64):
    jcfg = jreduced(jget_config("deepseek-v3-671b"), d_model=d_model)
    cfg = reduced(get_config("deepseek-v3-671b"), d_model=d_model)
    return (dataclasses.replace(jcfg, dtype=dtype),
            dataclasses.replace(cfg, dtype=dtype))


@pytest.fixture(scope="module")
def mla():
    jcfg, cfg = _cfgs()
    jp = JA.mla_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, from_jax_numpy(jax.device_get(jp), "cpu")


def _x(seed, B, S, d):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)


def _pos(B, S):
    return np.tile(np.arange(S, dtype=np.int32), (B, 1))


@pytest.mark.parametrize("window", [0, 5])
def test_plain_attention_mixed_v_dim_matches_reference(window):
    """MLA's decompressed prefill attends with Dq = 24 and Dv = 16 at the
    reduced width (192 and 128 at full width): (B, S, H, Dv) out, against
    the reference's blocked ``flash_attention_jnp`` in chunks of 8."""
    rng = np.random.default_rng(window)
    q, k = (rng.normal(size=(1, 32, 4, 24)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(1, 32, 4, 16)).astype(np.float32)
    want = JA.flash_attention_jnp(*map(jnp.asarray, (q, k, v)), causal=True,
                                  window=window, scale=0.3, q_chunk=8,
                                  kv_chunk=8)
    got = FA.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, window=window, scale=0.3)
    assert tuple(got.shape) == (1, 32, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_mla_init_layout_matches_reference():
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(dtype)
        want = jax.tree.map(np.asarray, jax.device_get(
            JA.mla_init(jax.random.PRNGKey(1), jcfg)))
        got = to_numpy(A.mla_init(torch.Generator().manual_seed(1), cfg,
                                  device="cpu"))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape
            assert a.dtype == (np.float32 if str(b.dtype) == "bfloat16"
                               else b.dtype)          # to_numpy: bf16 -> f32


@pytest.mark.parametrize("window", [0, 3])
def test_mla_forward_matches_reference(mla, window):
    """The output and the latents (``ckv``, ``k_rope``) it caches."""
    jcfg, cfg, jp, p = mla
    x, pos = _x(window, 2, 9, cfg.d_model), _pos(2, 9)
    jout, (jckv, jkr) = JA.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                       jcfg, window=window)
    out, (ckv, kr) = A.mla_forward(p, torch.from_numpy(x),
                                   torch.from_numpy(pos), cfg, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(ckv.numpy(), np.asarray(jckv), atol=ATOL)
    np.testing.assert_allclose(kr.numpy(), np.asarray(jkr), atol=ATOL)
    assert tuple(ckv.shape) == (2, 9, 16) and tuple(kr.shape) == (2, 9, 8)


def test_mla_forward_takes_kernel_and_ignores_it(mla):
    """As in the reference, ``kernel="pallas"`` is accepted and changes
    nothing: the flash kernel (one head dim for q, k and v) is never
    called, the output is bit-equal to ``"jnp"``'s. Another value is
    refused."""
    _, cfg, _, p = mla
    x, pos = torch.from_numpy(_x(1, 1, 7, cfg.d_model)), torch.from_numpy(_pos(1, 7))
    calls = FA.flash_attention.calls
    a, _ = A.mla_forward(p, x, pos, cfg, kernel="pallas")
    b, _ = A.mla_forward(p, x, pos, cfg, kernel="jnp")
    assert FA.flash_attention.calls == calls
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="kernel"):
        A.mla_forward(p, x, pos, cfg, kernel="triton")


@pytest.mark.parametrize("window", [0, 5])
def test_mla_decode_wrapped_ring_matches_reference(mla, window):
    """A latent ring of W=8 slots at t=13: slots hold positions 8..12 and
    5..7, the new token lands at slot 5 over position 5; the cache is
    written in place."""
    jcfg, cfg, jp, p = mla
    rng = np.random.default_rng(4)
    m = cfg.mla
    cache = {"ckv": rng.normal(size=(2, 8, m.kv_lora_rank)).astype(np.float32),
             "krope": rng.normal(size=(2, 8, m.qk_rope_dim)).astype(np.float32),
             "pos": np.array([8, 9, 10, 11, 12, 5, 6, 7], np.int32)}
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jout, jc = JA.mla_decode(jp, jnp.asarray(x),
                             {k: jnp.asarray(a) for k, a in cache.items()},
                             jnp.int32(13), jcfg, window=window)
    tc = {k: torch.from_numpy(a.copy()) for k, a in cache.items()}
    out, c = A.mla_decode(p, torch.from_numpy(x), tc, 13, cfg, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL)
        assert c[key] is tc[key]                     # written in place
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_mla_decode_matches_forward(mla):
    """The reference's own check on the port: the absorbed decode, token
    by token over a cache of S slots, ends on the forward's last row."""
    _, cfg, _, p = mla
    B, S = 2, 8
    x = torch.from_numpy(_x(5, B, S, cfg.d_model))
    full, _ = A.mla_forward(p, x, torch.from_numpy(_pos(B, S)), cfg)
    cache = A.mla_cache_init(cfg, B, S, torch.float32, device="cpu")
    for t in range(S):
        out, cache = A.mla_decode(p, x[:, t:t + 1], cache, t, cfg)
    np.testing.assert_allclose(out.numpy(), full[:, -1:].numpy(), atol=1e-4)


def test_mla_cache_init_matches_reference():
    jcfg, cfg = _cfgs()
    want = jax.device_get(JA.mla_cache_init(jcfg, 2, 8, jnp.float32))
    got = to_numpy(A.mla_cache_init(cfg, 2, 8, torch.float32, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, got, want)


def _bf16_step(x):
    return 2.0 ** (np.floor(np.log2(np.abs(np.asarray(x, np.float32)).max())) - 7)


def test_bf16_cast_points_match_reference():
    """bf16 weights and activations: the forward's output and latents and
    the decode's output come out bf16, within one bf16 step of their
    scale of the reference's (measured over 5 seeds: equal, every one;
    the bound leaves room for a product XLA and PyTorch round at another
    point)."""
    jcfg, cfg = _cfgs("bfloat16", d_model=128)
    jp = JA.mla_init(jax.random.PRNGKey(7), jcfg)
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    x, pos = _x(8, 2, 6, cfg.d_model), _pos(2, 6)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    jout, jkv = JA.mla_forward(jp, jx, jnp.asarray(pos), jcfg)
    out, kv = A.mla_forward(p, tx, torch.from_numpy(pos), cfg)
    for a, b in zip((out, *kv), (jout, *jkv)):
        assert a.dtype == torch.bfloat16
        diff = np.abs(a.float().numpy() - np.asarray(b, np.float32)).max()
        assert diff <= _bf16_step(b), diff
    W = 8
    jc = JA.mla_cache_init(jcfg, 2, W, jnp.bfloat16)
    c = A.mla_cache_init(cfg, 2, W, torch.bfloat16, device="cpu")
    for t in range(3):
        jo, jc = JA.mla_decode(jp, jx[:, t:t + 1], jc, jnp.int32(t), jcfg)
        o, c = A.mla_decode(p, tx[:, t:t + 1], c, t, cfg)
        assert o.dtype == torch.bfloat16 and c["ckv"].dtype == torch.bfloat16
        diff = np.abs(o.float().numpy() - np.asarray(jo, np.float32)).max()
        assert diff <= _bf16_step(jo), diff
