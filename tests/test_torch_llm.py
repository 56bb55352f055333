"""The port's LLM zoo against the JAX package on the CPU: configs, layers,
GQA attention, RWKV6, the transformer's prefill/decode and the
prefix-cached LLMServer.

Weights come from the reference's ``init_params`` and are converted
through ``repro_torch.convert``; inputs are numpy arrays from a seed.
float32 comparisons at 1e-5 (the model's own functions) and 1e-6 (single
layers); the bfloat16 cases are stated where they are made. The two
architectures run reduced and at 2 layers (one period of each group,
stacked twice), so the per-layer loop over the stacked axis is exercised.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import rwkv as JR
from repro.models import transformer as JT
from repro.serving.engine import LLMServer as JServer
from repro.serving.engine import Request as JRequest
from repro_torch.configs import ARCHS, NOT_PORTED, get_config, reduced
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import transformer as T
from repro_torch.serving.engine import LLMServer, Request

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs six
    test processes on the machine's cores, and the reduced models' small
    ops spread over every core in each of them wait at thread barriers
    (this file took 360 s at the default count against 202 s on two,
    beside five other heavy test files at -n 6)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _two_layers(cfg, dtype="float32"):
    specs = cfg.groups[0][0]
    return dataclasses.replace(cfg, groups=((specs, 2),), n_layers=2,
                               dtype=dtype)


def _cfgs(arch, dtype="float32", d_model=128):
    """(reference config, port config), reduced, 2 layers, ``dtype``."""
    return (_two_layers(jreduced(jget_config(arch), d_model=d_model), dtype),
            _two_layers(reduced(get_config(arch), d_model=d_model), dtype))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, cfg = _cfgs(request.param)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, from_jax_numpy(jax.device_get(jp), "cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


def _tokens(seed, S, vocab, B=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    full_j, full_p = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(full_p) == dataclasses.asdict(full_j)
    assert full_p.param_count() == full_j.param_count()
    assert full_p.active_param_count() == full_j.active_param_count()
    assert (full_p.q_dim, full_p.kv_dim) == (full_j.q_dim, full_j.kv_dim)
    assert dataclasses.asdict(reduced(full_p)) == dataclasses.asdict(
        jreduced(full_j))


def test_registry_refuses_unported_archs():
    assert set(ARCHS) | set(NOT_PORTED) == set(JARCHS)
    for arch in NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("gpt-5")


def test_full_width_shapes():
    """mistral-nemo's q_dim (4096) is not its d_model (5120); OLMoE holds
    6.92 B parameters of which 1.28 B are active per token (8 of its 64
    experts)."""
    cfg = get_config("mistral-nemo-12b")
    assert (cfg.d_model, cfg.q_dim, cfg.kv_dim) == (5120, 4096, 1024)
    assert round(cfg.param_count() / 1e9, 1) == 12.2
    assert cfg.active_param_count() == cfg.param_count()
    olmoe = get_config("olmoe-1b-7b")
    assert round(olmoe.param_count() / 1e9, 2) == 6.92
    assert round(olmoe.active_param_count() / 1e9, 2) == 1.28


# ----------------------------------------------------------------- layers

def test_rmsnorm_rope_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(3, 10, dtype=np.int32), (2, 1))
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_array_equal(L.rope_freqs(16, 1e6), JL.rope_freqs(16, 1e6))
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-6)
    x3 = x[:, :, 0]                                   # (..., S, D) form
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x3), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x3), jnp.asarray(pos), 1e4)),
        atol=1e-6)
    np.testing.assert_allclose(
        L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)).numpy(),
        np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        atol=1e-6)
    for act in ("swiglu", "relu2"):
        jp = JL.mlp_init(jax.random.PRNGKey(1), 16, 48, act)
        p = from_jax_numpy(jax.device_get(jp), "cpu")
        np.testing.assert_allclose(
            L.mlp(p, torch.from_numpy(x), act).numpy(),
            np.asarray(JL.mlp(jp, jnp.asarray(x), act)), atol=1e-5)


def test_rope_pairs_interleaved_lanes():
    """Lanes (0, 1) rotate together, not (0, D/2)."""
    x = torch.zeros((1, 1, 8))
    x[..., 1] = 1.0
    out = L.apply_rope(x, torch.tensor([[1]]), 10000.0)
    assert out[0, 0, 0] == pytest.approx(-np.sin(1.0), abs=1e-6)
    assert out[0, 0, 4] == 0.0


# -------------------------------------------------------------- attention

@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("Sq, Sk", [(20, 20), (7, 20)])
def test_flash_attention_jnp_matches_reference(window, Sq, Sk):
    """The port's prefill attention, ``flash_attention_plain``, against
    the reference's blocked ``flash_attention_jnp`` (chunks of 8, so the
    online softmax crosses blocks)."""
    rng = np.random.default_rng(Sq + window)
    q = rng.normal(size=(2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, Sk, 2, 16)).astype(np.float32) for _ in range(2))
    want = JA.flash_attention_jnp(*map(jnp.asarray, (q, k, v)), causal=True,
                                  window=window, q_chunk=8, kv_chunk=8)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def attn_case():
    jcfg, cfg = _cfgs("mistral-nemo-12b")
    jp = JA.attn_init(jax.random.PRNGKey(2), jcfg)
    return jcfg, cfg, jp, from_jax_numpy(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
def test_attn_forward_matches_reference(attn_case, kernel):
    """The port's prefill attention against both settings of the
    reference's kernel switch: its blocked plain attention, and the flash
    kernel in interpret mode."""
    jcfg, cfg, jp, p = attn_case
    x = np.random.default_rng(3).normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))
    jout, (jk, jv) = JA.attn_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                     window=4, kernel=kernel)
    out, (k, v) = A.attn_forward(p, torch.from_numpy(x), torch.from_numpy(pos),
                                 cfg, window=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("window", [0, 5])
def test_attn_decode_wrapped_ring_matches_reference(attn_case, window):
    """A ring of W=8 slots at t=13: slots hold positions 8..12 and 5..7,
    the new token lands at slot 5 over position 5."""
    jcfg, cfg, jp, p = attn_case
    rng = np.random.default_rng(4)
    W, t, KV, D = 8, 13, cfg.n_kv_heads, cfg.head_dim
    cache = {"k": rng.normal(size=(1, W, KV, D)).astype(np.float32),
             "v": rng.normal(size=(1, W, KV, D)).astype(np.float32),
             "pos": np.array([8, 9, 10, 11, 12, 5, 6, 7], np.int32)}
    x = rng.normal(size=(1, 1, cfg.d_model)).astype(np.float32)
    jout, jc = JA.attn_decode(jp, jnp.asarray(x),
                              {k: jnp.asarray(a) for k, a in cache.items()},
                              jnp.int32(t), jcfg, window=window)
    tc = {k: torch.from_numpy(a.copy()) for k, a in cache.items()}
    out, c = A.attn_decode(p, torch.from_numpy(x), tc, t, cfg, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(jc[key]), atol=ATOL)
        assert c[key] is tc[key]                     # written in place
    np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("S, W", [(5, 8), (8, 8), (13, 8)])
def test_pack_ring_matches_reference(S, W):
    """A prompt longer than the cache keeps its last W positions at slot
    p % W, as the reference's ring does."""
    full = np.random.default_rng(S).normal(size=(1, S, 2, 4)).astype(np.float32)
    positions = np.arange(S, dtype=np.int32)
    jbuf, jpos = JT._pack_ring(jnp.asarray(full), jnp.asarray(positions), W)
    buf, pos = T._pack_ring(torch.from_numpy(full), torch.from_numpy(positions), W)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


# ------------------------------------------------------------------- rwkv

@pytest.fixture(scope="module")
def rwkv_case():
    jcfg, cfg = _cfgs("rwkv6-1.6b")
    jp = JR.rwkv6_init(jax.random.PRNGKey(5), jcfg)
    jc = JR.cmix_init(jax.random.PRNGKey(6), jcfg)
    return (jcfg, cfg, jp, from_jax_numpy(jax.device_get(jp), "cpu"), jc,
            from_jax_numpy(jax.device_get(jc), "cpu"))


def test_rwkv6_tmix_matches_reference_prefill_and_steps(rwkv_case):
    jcfg, cfg, jp, p, _, _ = rwkv_case
    x = np.random.default_rng(7).normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    jout, (jlast, jstate) = JR.rwkv6_tmix(jp, jnp.asarray(x), jcfg)
    out, (last, state) = R.rwkv6_tmix(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=ATOL)
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    # step by step, each step against the reference's step
    js = jx = None
    s = xp = None
    for t in range(x.shape[1]):
        jo, (jx, js) = JR.rwkv6_tmix(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                     state=js, x_prev=jx)
        o, (xp, s) = R.rwkv6_tmix(p, torch.from_numpy(x[:, t:t + 1]), cfg,
                                  state=s, x_prev=xp)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL)


def test_rwkv6_cmix_matches_reference(rwkv_case):
    jcfg, cfg, _, _, jc, c = rwkv_case
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    prev = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    for xp in (None, prev):
        jout, jlast = JR.rwkv6_cmix(jc, jnp.asarray(x), jcfg,
                                    x_prev=None if xp is None else jnp.asarray(xp))
        out, last = R.rwkv6_cmix(c, torch.from_numpy(x), cfg,
                                 x_prev=None if xp is None else torch.from_numpy(xp))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
        np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


# ------------------------------------------------------------ transformer

def test_init_params_layout_matches_reference(model):
    """The port's own init builds the reference's tree: same keys,
    shapes (a leading count axis per group) and dtypes."""
    jcfg, cfg, jp, _ = model
    mine = to_numpy(T.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"))
    want = jax.tree.map(np.asarray, jax.device_get(jp))
    assert (jax.tree.structure(mine) == jax.tree.structure(want))
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_init_params_deterministic_per_seed():
    _, cfg = _cfgs("rwkv6-1.6b")
    a, b = (to_numpy(T.init_params(cfg, torch.Generator().manual_seed(s),
                                   device="cpu")) for s in (3, 3))
    jax.tree.map(np.testing.assert_array_equal, a, b)


def _caches_close(got, want):
    """Each cache leaf within 1e-5 of its own scale (its largest |value|,
    at least 1): the RWKV state sums many steps and grows to ~7, where
    float32 summation order alone moves an element by ~1.3e-5."""
    def close(g, w):
        w = np.asarray(w, np.float32)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_np(g), w, atol=ATOL * scale, rtol=0)
    jax.tree.map(close, got, want)


def test_prefill_and_decode_match_reference(model):
    """prefill of a 21-token prompt into a 16-slot cache (the ring wraps
    for the attention arch), then 5 decode steps: logits at 1e-5 and the
    caches (``_caches_close``) after every call."""
    jcfg, cfg, jp, p = model
    tokens = _tokens(9, 21, cfg.vocab_size)
    jlog, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), cache_len=16)
    log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), cache_len=16)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL)
    _caches_close(cache, jcache)
    for step in range(5):
        t = 21 + step
        tok = _tokens(10 + step, 1, cfg.vocab_size)
        jlog, jcache = JT.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                      jnp.int32(t))
        log, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache, t)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL)
        _caches_close(cache, jcache)


def test_windowed_decode_matches_reference():
    jcfg, cfg = _cfgs("mistral-nemo-12b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(11))
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    tokens = _tokens(12, 10, cfg.vocab_size)
    jlog, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), cache_len=12,
                              window_attn=4)
    log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), cache_len=12,
                           window_attn=4)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL)
    for t in range(10, 15):
        tok = _tokens(t, 1, cfg.vocab_size)
        jlog, jcache = JT.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                      jnp.int32(t), window_attn=4)
        log, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache, t,
                                   window_attn=4)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL)


def test_decode_moe_pre_hook_matches_reference():
    """decode_step's ``moe_pre`` runs on each MoE layer's input before
    its dispatch, once a layer, as the reference's does: the same logits
    at 1e-5 with a hook that halves the input, which moves them."""
    jcfg, cfg = _cfgs("olmoe-1b-7b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(23))
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    tokens = _tokens(24, 10, cfg.vocab_size)
    _, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), cache_len=16)
    _, cache = T.prefill(p, cfg, torch.from_numpy(tokens), cache_len=16)
    tok = _tokens(25, 1, cfg.vocab_size)
    calls = []

    def halve(h):
        calls.append(h.shape)
        return h * 0.5

    jlog, _ = JT.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                             jnp.int32(10), moe_pre=lambda h: h * 0.5)
    plain, _ = T.decode_step(p, cfg, torch.from_numpy(tok), T.clone(cache),
                             10)
    log, _ = T.decode_step(p, cfg, torch.from_numpy(tok), cache, 10,
                           moe_pre=halve)
    assert calls == [(1, 1, cfg.d_model)] * cfg.n_layers
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL)
    assert float((log - plain).abs().max()) > 1e-3


def test_init_cache_matches_reference(model):
    jcfg, cfg, _, _ = model
    want = jax.device_get(JT.init_cache(jcfg, 2, 8))
    got = to_numpy(T.init_cache(cfg, 2, 8, device="cpu"))
    # the reference's rwkv layer cache drops cshift too
    jax.tree.map(np.testing.assert_array_equal, got, want)


def _bf16_scale_ulp(x):
    """One bf16 step at the size of ``x``'s largest element."""
    return 2.0 ** (np.floor(np.log2(np.abs(np.asarray(x, np.float32)).max())) - 7)


def test_bf16_cast_points_match_reference():
    """bf16 weights and activations, function by function: the same cast
    points give the same dtypes, and products that both sides sum in
    float32 and round once come out within one bf16 step of the output's
    scale (measured: equal). The RWKV decay is float32 (1.5e-5 measured);
    ``g`` goes through silu, which XLA and PyTorch round differently in
    bf16 (up to 2 steps of the element, half a step of the scale)."""
    x = np.random.default_rng(7).normal(size=(2, 6, 128)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)

    jcfg, cfg = _cfgs("rwkv6-1.6b", dtype="bfloat16")
    jp = JR.rwkv6_init(jax.random.PRNGKey(5), jcfg)
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    assert {k: p[k].dtype for k in ("w0", "u", "wr")} == {
        "w0": torch.float32, "u": torch.float32, "wr": torch.bfloat16}
    want = JR._tmix_projections(jp, jx, jx * 0.5, jcfg)
    got = R._tmix_projections(p, tx, tx * 0.5, cfg)
    for name, a, b in zip("rkvwg", got, want):
        assert str(a.dtype).split(".")[-1] == str(b.dtype), name
        tol = 2e-5 if name == "w" else _bf16_scale_ulp(b)
        assert np.abs(_np(a) - np.asarray(b, np.float32)).max() <= tol, name
    jout, (_, jstate) = JR.rwkv6_tmix(jp, jx, jcfg)
    out, (_, state) = R.rwkv6_tmix(p, tx, cfg)
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert np.abs(_np(out) - np.asarray(jout, np.float32)).max() <= \
        _bf16_scale_ulp(jout)

    jcfg, cfg = _cfgs("mistral-nemo-12b", dtype="bfloat16")
    jp = JA.attn_init(jax.random.PRNGKey(2), jcfg)
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    jout, jkv = JA.attn_forward(jp, jx, jnp.asarray(pos), jcfg)
    out, kv = A.attn_forward(p, tx, torch.from_numpy(pos), cfg)
    for a, b in zip((out, *kv), (jout, *jkv)):
        assert a.dtype == torch.bfloat16
        assert np.abs(_np(a) - np.asarray(b, np.float32)).max() <= \
            _bf16_scale_ulp(b)


def _xla_cpu_sigmoid(x):
    """A bf16 sigmoid as XLA computes it on the CPU: each op rounded to
    bf16 (bit-equal to ``jax.nn.sigmoid`` there, where PyTorch's rounds
    once and differs in about a third of the elements)."""
    return 1 / (1 + torch.exp(-x))


def _bf16_layer(layer, jx):
    """(reference params, the reference's output, port(params, x)) for one
    bf16 layer at reduced width; ``port`` runs the port's function."""
    key = jax.random.PRNGKey(17)
    if layer == "rmsnorm":
        scale = np.random.default_rng(18).normal(size=(jx.shape[-1],))
        jp = {"scale": jnp.asarray(scale, jnp.bfloat16)}
        return jp, JL.rmsnorm(jp, jx), L.rmsnorm
    if layer == "mlp":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          JL.mlp_init(key, jx.shape[-1], 384, "swiglu"))
        return jp, JL.mlp(jp, jx, "swiglu"), lambda p, x: L.mlp(p, x, "swiglu")
    if layer == "rwkv6_cmix":
        jcfg, cfg = _cfgs("rwkv6-1.6b", dtype="bfloat16")
        jp = JR.cmix_init(key, jcfg)
        want, _ = JR.rwkv6_cmix(jp, jx, jcfg, x_prev=jx[:, :1] * 0.5)
        return jp, want, lambda p, x: R.rwkv6_cmix(p, x, cfg,
                                                   x_prev=x[:, :1] * 0.5)[0]
    # attn_decode: a bf16 ring of W=8 slots at t=13, window 5
    jcfg, cfg = _cfgs("mistral-nemo-12b", dtype="bfloat16")
    kv = np.random.default_rng(19).normal(
        size=(2, 1, 8, cfg.n_kv_heads, cfg.head_dim))
    jp = {"attn": JA.attn_init(key, jcfg),
          "cache": {"k": jnp.asarray(kv[0], jnp.bfloat16),
                    "v": jnp.asarray(kv[1], jnp.bfloat16),
                    "pos": jnp.array([8, 9, 10, 11, 12, 5, 6, 7], jnp.int32)}}
    want, _ = JA.attn_decode(jp["attn"], jx[:1, :1], jp["cache"],
                             jnp.int32(13), jcfg, window=5)
    return jp, want, lambda p, x: A.attn_decode(
        p["attn"], x[:1, :1], p["cache"], 13, cfg, window=5)[0]


@pytest.mark.parametrize("layer", ["rmsnorm", "mlp", "rwkv6_cmix", "attn_decode"])
def test_bf16_layer_matches_reference(layer, monkeypatch):
    """One bf16 layer against the reference's, with XLA's CPU sigmoid
    given to the port, so that what can differ is where each side rounds
    to bf16. The output is bf16, within one bf16 step of its scale
    (measured over 5 seeds: rmsnorm and attn_decode equal, mlp 0.06
    steps, cmix 1.0), and at most a quarter of its elements differ at all
    (measured: none; under 0.3 %; 9-10 %, where the float32 token-shift
    mix rounds in another order; none). The same layers computed in
    float32 and rounded once at the end also land within a step of the
    scale, but differ in 63-72 % of the mlp's and cmix's elements, so the
    share is what pins the cast points."""
    monkeypatch.setattr(torch, "sigmoid", _xla_cpu_sigmoid)
    monkeypatch.setattr(torch.nn.functional, "silu",
                        lambda x: x * _xla_cpu_sigmoid(x))
    x = np.random.default_rng(16).normal(size=(2, 6, 128)).astype(np.float32)
    jp, want, port = _bf16_layer(layer, jnp.asarray(x, jnp.bfloat16))
    got = port(from_jax_numpy(jax.device_get(jp), "cpu"),
               torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    diff = np.abs(_np(got) - np.asarray(want, np.float32))
    assert diff.max() <= _bf16_scale_ulp(want), diff.max()
    assert (diff > 0).mean() <= 0.25, (diff > 0).mean()


def _bf16_track(arch, seed):
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    assert p["lm_head"]["w"].dtype == torch.bfloat16
    tokens = _tokens(14, 12, cfg.vocab_size)
    jlog, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), cache_len=16)
    log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), cache_len=16)
    diffs = []
    for t in range(12, 16):
        assert log.dtype == torch.bfloat16
        jax.tree.map(lambda a, b: str(a.dtype).split(".")[-1] == str(b.dtype)
                     or pytest.fail(f"{a.dtype} != {b.dtype}"), cache, jcache)
        diffs.append(np.abs(_np(log) - np.asarray(jlog, np.float32)).max())
        tok = _tokens(t, 1, cfg.vocab_size)
        jlog, jcache = JT.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                      jnp.int32(t))
        log, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache, t)
    assert max(diffs) <= 0.1, diffs


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if not get_config(a).n_experts])
def test_bf16_prefill_and_decode_track_reference(arch):
    """A bf16 model end to end: logits and every cache leaf in the
    reference's dtypes, logits (largest ~3.5) within 0.1. Measured over
    three seeds: up to 0.064, 4 bf16 steps, from the silu/sigmoid
    roundings above compounding through 2 layers; a float32 run of the
    same weights lands as close, so this test pins dtypes and scale and
    ``test_bf16_cast_points_match_reference`` pins the casts. The MoE
    arch has its own case below."""
    _bf16_track(arch, 13)


def test_bf16_moe_prefill_and_decode_track_reference():
    """The same for reduced OLMoE, on weights from seed 14. Seed 13's
    weights put a near-tie in the router: at the decode step t=12 the
    2nd and 3rd of layer 0's router probabilities lie 7.6e-4 apart,
    while the router's bf16 inputs differ by one bf16 step (0.016) from
    the roundings above, so the two sides pick different experts and the
    logits move by 2.6. That is a routing decision taken on a bf16
    rounding, not a fault; seeds 14-17 route alike on both sides (logits
    within 0.051, no flipped pick). The float32 parity of the MoE path,
    routing included, is ``test_prefill_and_decode_match_reference``'s
    and ``tests/test_torch_moe.py``'s."""
    _bf16_track("olmoe-1b-7b", 14)


@pytest.mark.parametrize("arch, dtype, window", [
    ("olmoe-1b-7b", "float32", 0), ("mistral-nemo-12b", "float32", 0),
    ("olmoe-1b-7b", "bfloat16", 0), ("mistral-nemo-12b", "bfloat16", 0),
    ("mistral-nemo-12b", "float32", 5)])
def test_prefill_pallas_switch_matches_reference(arch, dtype, window):
    """``prefill(kernel="pallas")`` against the reference's, which runs
    its Pallas flash kernel in interpret mode here: float32 logits and
    caches at 1e-5, bf16 logits (largest ~3.6) within the bf16 test's 0.1
    (measured: 0.023 for both archs, where the reference's Pallas and
    plain prefills agree bit for bit). The prompt's attention goes through the flash
    wrapper once a layer, and on the CPU its plain version makes the
    switch bit-equal to the port's ``"jnp"`` prefill."""
    from repro_torch.kernels import flash_attention as FA
    jcfg, cfg = _cfgs(arch, dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(21))
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    tokens = _tokens(22, 12, cfg.vocab_size)
    kw = dict(cache_len=16, window_attn=window)
    jlog, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), kernel="pallas",
                              **kw)
    calls = FA.flash_attention.calls
    log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), kernel="pallas",
                           **kw)
    assert FA.flash_attention.calls == calls + cfg.n_layers
    plain, plain_cache = T.prefill(p, cfg, torch.from_numpy(tokens), **kw)
    assert torch.equal(log, plain)
    jax.tree.map(lambda a, b: torch.equal(a, b) or pytest.fail("cache"),
                 cache, plain_cache)
    if dtype == "float32":
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL)
        _caches_close(cache, jcache)
    else:
        assert log.dtype == torch.bfloat16
        diff = np.abs(_np(log) - np.asarray(jlog, np.float32)).max()
        assert diff <= 0.1, diff


def test_unported_parts_name_roadmap_item():
    jcfg = reduced(get_config("mistral-nemo-12b"))
    mamba = dataclasses.replace(jcfg, groups=(((dataclasses.replace(
        jcfg.groups[0][0][0], mixer="mamba"),), 1),))
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        T.init_params(mamba, torch.Generator(), device="cpu")
    cross = dataclasses.replace(jcfg, groups=(((dataclasses.replace(
        jcfg.groups[0][0][0], cross=True),), 1),))
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        T.init_params(cross, torch.Generator(), device="cpu")


# ----------------------------------------------------------------- server

def _llm_generate_mix(server_cls, request_cls, srv):
    """The mix of examples/llm_generate.py: a 32-token system prompt, then
    4 users of +2 tokens, 8 new tokens each."""
    system_prompt = np.arange(1, 33, dtype=np.int32)
    out = [srv.serve_one(request_cls("warm", system_prompt, max_new_tokens=1))]
    for i in range(4):
        u = np.array([40 + i, 50 + i], np.int32)
        out.append(srv.serve_one(request_cls(
            f"u{i}", np.concatenate([system_prompt, u]), max_new_tokens=8)))
    # the prompt identical to a stored one: the re-decode path
    out.append(srv.serve_one(request_cls("again", system_prompt,
                                         max_new_tokens=3)))
    return out


def test_server_matches_reference_server(model):
    jcfg, cfg, jp, p = model
    jres = _llm_generate_mix(JServer, JRequest, JServer(jcfg, jp, cache_len=96))
    srv = LLMServer(cfg, p, cache_len=96, device="cpu")
    res = _llm_generate_mix(LLMServer, Request, srv)
    jsrv_stats = JServer(jcfg, jp, cache_len=96)
    _llm_generate_mix(JServer, JRequest, jsrv_stats)
    assert srv.stats == jsrv_stats.stats
    assert srv.stats["prefix_hits"] == 5
    for a, b in zip(res, jres):
        assert (a.rid, a.prefix_hit, a.prefill_tokens) == \
            (b.rid, b.prefix_hit, b.prefill_tokens)
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.tokens.dtype == np.int32


def test_eos_stops_like_the_reference(model):
    """A request stops at its eos token, as the reference's server does."""
    jcfg, cfg, jp, p = model
    prompt = np.arange(3, 20, dtype=np.int32)
    free = JServer(jcfg, jp, cache_len=48).serve_one(
        JRequest("free", prompt, max_new_tokens=8))
    eos = int(np.asarray(free.tokens)[2])
    want = JServer(jcfg, jp, cache_len=48)
    got = LLMServer(cfg, p, cache_len=48, device="cpu")
    a = got.serve_one(Request("eos", prompt, max_new_tokens=8, eos_id=eos))
    b = want.serve_one(JRequest("eos", prompt, max_new_tokens=8, eos_id=eos))
    np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
    assert len(a.tokens) <= 3 and a.tokens[-1] == eos
    assert got.stats == want.stats


def test_prefix_hit_tokens_equal_a_cold_server(model):
    _, cfg, _, p = model
    warm = LLMServer(cfg, p, cache_len=96, device="cpu")
    cold = LLMServer(cfg, p, cache_len=96, device="cpu",
                     enable_prefix_cache=False)
    res = _llm_generate_mix(LLMServer, Request, warm)
    ref = _llm_generate_mix(LLMServer, Request, cold)
    assert cold.stats["prefix_hits"] == 0
    for a, b in zip(res[1:5], ref[1:5]):
        assert a.prefix_hit and not b.prefix_hit
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_stored_prefix_entry_unchanged_by_later_hits(model):
    """The port decodes in place; a stored entry must stay a snapshot."""
    _, cfg, _, p = model
    srv = LLMServer(cfg, p, cache_len=48, device="cpu")
    system_prompt = np.arange(1, 17, dtype=np.int32)
    srv.serve_one(Request("sys", system_prompt, max_new_tokens=4))
    (key, (entry, _)), = srv.prefix_cache.items()
    before = jax.tree.map(lambda a: a.clone(), entry)
    for i in range(3):
        r = srv.serve_one(Request(f"u{i}", np.concatenate(
            [system_prompt, [60 + i]]).astype(np.int32), max_new_tokens=5))
        assert r.prefix_hit
    after = srv.prefix_cache[key][0]
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        _np(a), _np(b)), after, before)


def test_server_refuses_mismatched_device(model):
    _, cfg, _, p = model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LLMServer(cfg, p)
    else:
        with pytest.raises(ValueError, match="params live on"):
            LLMServer(cfg, p)


# ---------------------------------------------------------------- convert

def test_convert_round_trips_bf16():
    x = jnp.asarray(np.random.default_rng(15).normal(size=(3, 5)), jnp.bfloat16)
    t = from_jax_numpy({"w": jax.device_get(x)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    back = to_numpy({"w": t})["w"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, np.asarray(x.astype(jnp.float32)))
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(jax.device_get(x)).view(np.int16))


def test_launcher_on_cpu(capsys):
    from repro_torch.launch.llm_generate import main
    main(["--device", "cpu", "--arch", "rwkv6-1.6b"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and "4/4 prefix hits" in out[0]
    assert out[0].endswith("on cpu")
    with pytest.raises(SystemExit, match="ROADMAP item 11"):
        main(["--device", "cpu", "--arch", "deepseek-v3-671b"])
