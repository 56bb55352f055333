"""The port's Mamba block (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU.

Weights come from the reference's ``mamba_init`` and are converted
through ``repro_torch.convert``; inputs are numpy arrays from a seed.
float32 at the reference's own tolerances (``tests/test_ssm_rwkv.py``):
outputs and the SSM state at 1e-4, the conv state at 1e-5. The bf16
case pins the reference's cast points.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import ssm as JS
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.models import ssm as S

ATOL = 1e-4
CONV_ATOL = 1e-5


def _cfgs(dtype="float32", d_model=64):
    jcfg = jreduced(jget_config("jamba-v0.1-52b"), d_model=d_model)
    cfg = reduced(get_config("jamba-v0.1-52b"), d_model=d_model)
    return (dataclasses.replace(jcfg, dtype=dtype),
            dataclasses.replace(cfg, dtype=dtype))


@pytest.fixture(scope="module")
def mamba():
    jcfg, cfg = _cfgs()
    jp = JS.mamba_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, from_jax_numpy(jax.device_get(jp), "cpu")


def _x(seed, B, S_, d):
    return np.random.default_rng(seed).normal(size=(B, S_, d)).astype(np.float32)


def test_dt_rank_and_init_layout_match_reference(mamba):
    """The port's own init builds the reference's tree: the same keys,
    shapes and dtypes, ``A_log``, ``D`` and ``dt_bias`` float32 in a
    bf16 model too, and the same deterministic leaves (A_log, D,
    dt_bias, conv_b)."""
    jcfg, cfg, jp, _ = mamba
    assert S.dt_rank(cfg) == JS.dt_rank(jcfg) == 4
    for dtype in ("float32", "bfloat16"):
        jc, c = _cfgs(dtype)
        want = jax.tree.map(np.asarray, jax.device_get(
            JS.mamba_init(jax.random.PRNGKey(1), jc)))
        got = to_numpy(S.mamba_init(torch.Generator().manual_seed(1), c,
                                    device="cpu"))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape
            assert a.dtype == (np.float32 if str(b.dtype) == "bfloat16"
                               else b.dtype)          # to_numpy: bf16 -> f32
        for k in ("A_log", "D", "dt_bias"):
            assert want[k].dtype == np.float32, k
        for k in ("D", "dt_bias", "conv_b"):
            np.testing.assert_array_equal(got[k], want[k].astype(np.float32))
        # log(1..16): the two libraries' logs differ by one float32 ulp
        np.testing.assert_allclose(got["A_log"], want["A_log"], rtol=1.2e-7,
                                   atol=0)


@pytest.mark.parametrize("S_", [2, 9])
def test_mamba_forward_matches_reference(mamba, S_):
    """S=2 is shorter than the conv's d_conv - 1 = 3 steps of state, which
    the reference pads on the left."""
    jcfg, cfg, jp, p = mamba
    x = _x(S_, 2, S_, cfg.d_model)
    jout, (jconv, jh) = JS.mamba_forward(jp, jnp.asarray(x), jcfg)
    out, (conv, h) = S.mamba_forward(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), atol=CONV_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
    assert h.dtype == torch.float32 and tuple(conv.shape) == (2, 3, 128)


def test_mamba_decode_steps_match_reference_in_place(mamba):
    """Step by step from a zero cache, each step against the reference's:
    the output, and a cache written in place (the same tensors come back)."""
    jcfg, cfg, jp, p = mamba
    x = _x(3, 2, 7, cfg.d_model)
    jcache = JS.mamba_cache_init(jcfg, 2, jnp.float32)
    cache = S.mamba_cache_init(cfg, 2, torch.float32, device="cpu")
    assert isinstance(cache, tuple)
    for t in range(x.shape[1]):
        jo, jcache = JS.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                                     jcfg)
        o, got = S.mamba_decode(p, torch.from_numpy(x[:, t:t + 1]), cache, cfg)
        assert got[0] is cache[0] and got[1] is cache[1]
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)
        np.testing.assert_allclose(cache[0].numpy(), np.asarray(jcache[0]),
                                   atol=CONV_ATOL)
        np.testing.assert_allclose(cache[1].numpy(), np.asarray(jcache[1]),
                                   atol=ATOL)


def test_mamba_decode_matches_forward(mamba):
    """The reference's own check on the port: decoding token by token
    gives the forward's outputs, and the forward's cache equals the one
    the steps accumulate."""
    _, cfg, _, p = mamba
    x = torch.from_numpy(_x(4, 2, 9, cfg.d_model))
    full, (conv_f, h_f) = S.mamba_forward(p, x, cfg)
    cache = S.mamba_cache_init(cfg, 2, torch.float32, device="cpu")
    outs = [S.mamba_decode(p, x[:, t:t + 1], cache, cfg)[0]
            for t in range(x.shape[1])]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(cache[1].numpy(), h_f.numpy(), atol=ATOL)
    np.testing.assert_allclose(cache[0].numpy(), conv_f.numpy(),
                               atol=CONV_ATOL)


def test_mamba_prefill_then_decode_continues_the_state(mamba):
    """A forward over the first tokens, then decode steps from its cache,
    against the reference doing the same."""
    jcfg, cfg, jp, p = mamba
    x = _x(5, 1, 10, cfg.d_model)
    _, jcache = JS.mamba_forward(jp, jnp.asarray(x[:, :6]), jcfg)
    _, cache = S.mamba_forward(p, torch.from_numpy(x[:, :6]), cfg)
    cache = tuple(a.clone() for a in cache)
    for t in range(6, 10):
        jo, jcache = JS.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                                     jcfg)
        o, _ = S.mamba_decode(p, torch.from_numpy(x[:, t:t + 1]), cache, cfg)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)


def test_mamba_causality(mamba):
    _, cfg, _, p = mamba
    x = torch.from_numpy(_x(6, 1, 8, cfg.d_model))
    y1, _ = S.mamba_forward(p, x, cfg)
    x2 = x.clone()
    x2[:, 5:] = 0.0
    y2, _ = S.mamba_forward(p, x2, cfg)
    np.testing.assert_allclose(y1[:, :5].numpy(), y2[:, :5].numpy(), atol=1e-6)


def _bf16_step(x):
    """One bf16 step at the size of ``x``'s largest element."""
    return 2.0 ** (np.floor(np.log2(np.abs(np.asarray(x, np.float32)).max())) - 7)


def _xla_cpu_silu(x):
    """A bf16 silu as XLA computes it on the CPU: each op rounded to bf16
    (``tests/test_torch_llm.py`` pins the other mixers the same way)."""
    return x * (1 / (1 + torch.exp(-x)))


def test_bf16_cast_points_match_reference(monkeypatch):
    """bf16 weights and activations, with XLA's CPU silu given to the
    port, so that what can differ is where each side rounds to bf16: the
    projections come out float32 (dt, B, C), the scan's state float32,
    the output and the conv state bf16, as in the reference. The output
    lies within one bf16 step of its scale (measured over 5 seeds: at
    most 0.25 steps, in under 1 % of the elements), the state within 1e-6
    of its scale (measured: 8e-8) and the conv state and a decode step
    from it equal. With PyTorch's own silu, which rounds once, the output
    moves by up to 2 steps and the state by 1e-2."""
    monkeypatch.setattr(torch.nn.functional, "silu", _xla_cpu_silu)
    jcfg, cfg = _cfgs("bfloat16", d_model=128)
    jp = JS.mamba_init(jax.random.PRNGKey(7), jcfg)
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    x = _x(8, 2, 6, cfg.d_model)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    di = cfg.mamba.d_inner(cfg.d_model)
    want = JS._projections(jp, jnp.asarray(np.ones((2, 6, di)), jnp.bfloat16),
                           jcfg)
    got = S._projections(p, torch.ones((2, 6, di), dtype=torch.bfloat16), cfg)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and str(b.dtype) == "float32"
    jout, (jconv, jh) = JS.mamba_forward(jp, jx, jcfg)
    out, (conv, h) = S.mamba_forward(p, tx, cfg)
    assert (out.dtype, conv.dtype, h.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32)
    diff = np.abs(out.float().numpy() - np.asarray(jout, np.float32))
    assert diff.max() <= _bf16_step(jout), diff.max()
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    np.testing.assert_array_equal(conv.float().numpy(),
                                  np.asarray(jconv, np.float32))
    scale = max(1.0, float(np.abs(np.asarray(jh)).max()))
    assert np.abs(h.numpy() - np.asarray(jh)).max() <= 1e-6 * scale
    cache = (conv.clone(), h.clone())
    jo, _ = JS.mamba_decode(jp, jx[:, :1], (jconv, jh), jcfg)
    o, _ = S.mamba_decode(p, tx[:, :1], cache, cfg)
    assert o.dtype == torch.bfloat16 and cache[1].dtype == torch.float32
    np.testing.assert_array_equal(o.float().numpy(), np.asarray(jo, np.float32))
