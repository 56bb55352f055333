"""The port's LLM zoo against the JAX package on the CPU: configs, layers,
GQA attention, RWKV6, the transformer's prefill/decode and the
prefix-cached LLMServer.

Weights come from the reference's ``init_params`` and are converted
through ``repro_torch.convert``; inputs are numpy arrays from a seed.
float32 comparisons at 1e-5 (the model's own functions) and 1e-6 (single
layers), and for reduced Jamba's 16 layers the whole-model tolerance of
``tests/test_archs_smoke.py`` (5e-4); the bfloat16 cases are stated
where they are made. The architectures run reduced with every group's
period stacked twice (2 layers for the one-layer periods, 4 for
DeepSeek's dense and MoE groups, 16 for Jamba's 8-layer period), so the
per-layer loop over the stacked axis is exercised (10 layers for
Llama-3.2-Vision's 5-layer period, 4 self-attention and 1 gated
cross-attention). The conditioned archs take a seeded ``cond``
(``cond_seq_len`` 8, ``cond_dim`` 32) and Llama-Vision's gates are set to
0.5 (``_open_gates``: at their initial 0 the image would never reach the
logits); MusicGen's prompts are (B, S, 4) tokens. Mamba, MLA and
cross-attention alone are ``tests/test_torch_ssm.py``'s,
``tests/test_torch_mla.py``'s and ``tests/test_torch_cross_attention.py``'s.
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
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch.llm_generate import codebooks, stub_cond
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import transformer as T
from repro_torch.serving.engine import LLMServer, Request

ATOL = 1e-5
# reduced Jamba's 16 layers (14 selective scans, 8 MoE layers): the
# whole-model tolerance of tests/test_archs_smoke.py (measured: 5.5e-5)
WHOLE_MODEL_ATOL = 5e-4


def _atol(cfg):
    return WHOLE_MODEL_ATOL if cfg.arch_type == "hybrid" else ATOL


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
    """Each group's period stacked twice."""
    groups = tuple((specs, 2) for specs, _ in cfg.groups)
    return dataclasses.replace(cfg, groups=groups, dtype=dtype,
                               n_layers=sum(2 * len(s) for s, _ in groups))


def _cfgs(arch, dtype="float32", d_model=128):
    """(reference config, port config), reduced, 2 layers, ``dtype``."""
    return (_two_layers(jreduced(jget_config(arch), d_model=d_model), dtype),
            _two_layers(reduced(get_config(arch), d_model=d_model), dtype))


GATE = 0.5     # Llama-Vision's cross-attention gates in every test


def _open_gates(jp, jcfg):
    """The reference's tree with every ``gate_attn`` set to GATE."""
    for gi, (specs, count) in enumerate(jcfg.groups):
        for i, spec in enumerate(specs):
            if spec.mixer == "cross_attn":
                jp["groups"][str(gi)][str(i)]["gate_attn"] = jnp.full(
                    (count,), GATE, jnp.float32)
    return jp


def _init(jcfg, seed):
    """(reference params with open gates, the same converted)."""
    jp = _open_gates(JT.init_params(jcfg, jax.random.PRNGKey(seed)), jcfg)
    return jp, from_jax_numpy(jax.device_get(jp), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, cfg = _cfgs(request.param)
    return (jcfg, cfg) + _init(jcfg, 0)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


def _tokens(seed, S, cfg, B=1):
    """Random (B, S) tokens, or (B, S, ncb) for a multi-codebook cfg."""
    shape = (B, S) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _jcond(cfg, seed):
    """The launcher's stub ``cond`` from ``seed`` as a (1, Cs, cond_dim)
    JAX array (None for an arch without a frontend)."""
    c = stub_cond(cfg, seed)
    return None if c is None else jnp.asarray(c[None])


def _tcond(cfg, seed):
    """The same as a tensor."""
    c = stub_cond(cfg, seed)
    return None if c is None else torch.from_numpy(c[None])


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
    """The registry serves every architecture of the reference's (the
    last two, cross-attention and MusicGen, since they were ported) and
    refuses only names it does not know."""
    assert set(ARCHS) == set(JARCHS) and len(ARCHS) == 10
    for arch in ("llama-3.2-vision-11b", "musicgen-large"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jget_config(arch))
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


def test_hybrid_and_mla_full_width_and_depth_cuts():
    """Jamba-v0.1 holds 51.6 B parameters (12.1 B active: 2 of 16
    experts), DeepSeek-V3 671.0 B (37.6 B active, the MTP head left out
    as the reference's count leaves it). Neither fits one 80 GB card in
    bf16, so the card runs cuts of depth at full width: Jamba's first 2
    of its 4 periods (16 layers: 14 Mamba, 2 attention, 8 MoE), 26.05 B;
    DeepSeek's 3 dense layers and 2 of its 58 MoE layers without the MTP
    head, 26.62 B."""
    jamba, ds = get_config("jamba-v0.1-52b"), get_config("deepseek-v3-671b")
    assert round(jamba.param_count() / 1e9, 2) == 51.57
    assert round(jamba.active_param_count() / 1e9, 2) == 12.11
    assert round(ds.param_count() / 1e9, 2) == 671.03
    assert round(ds.active_param_count() / 1e9, 2) == 37.55
    (period, _), = jamba.groups
    cut = dataclasses.replace(jamba, groups=((period, 2),), n_layers=16)
    kinds = [s.mixer for s in period] * 2
    assert (kinds.count("mamba"), kinds.count("attn")) == (14, 2)
    assert round(cut.param_count() / 1e9, 2) == 26.05
    (dense, _), (moe, _) = ds.groups
    cut = dataclasses.replace(ds, groups=((dense, 3), (moe, 2)), n_layers=5,
                              mtp=False)
    assert round(cut.param_count() / 1e9, 2) == 26.62


def test_conditioned_full_width_trees():
    """The full-width trees, shaped by the reference's ``init_params``
    without drawing them: Llama-3.2-Vision holds 9.780 B parameters, as
    ``param_count()`` says (to the norms and gates it leaves out);
    MusicGen-large 4.062 B, where ``param_count()``
    (the reference's formula, kept so the configs match) says 3.810 B: it
    counts the conditioning sublayer's wk/wv as cond_dim x kv_dim, where
    ``cond_proj`` runs first and makes them d_model x kv_dim."""
    counts = {}
    for arch in ("llama-3.2-vision-11b", "musicgen-large"):
        shapes = jax.eval_shape(lambda k, a=arch: JT.init_params(
            jget_config(a), k), jax.random.PRNGKey(0))
        counts[arch] = sum(int(np.prod(a.shape))
                           for a in jax.tree.leaves(shapes))
    llama, music = (get_config(a) for a in counts)
    assert round(counts["llama-3.2-vision-11b"] / 1e9, 3) == 9.780
    assert round(llama.param_count() / 1e9, 3) == 9.780
    # beside the formula: the final norm and the 8 gates
    assert counts["llama-3.2-vision-11b"] - llama.param_count() == \
        llama.d_model + 8
    assert round(counts["musicgen-large"] / 1e9, 3) == 4.062
    assert round(music.param_count() / 1e9, 3) == 3.810
    # the sublayer's wk/wv, and the final and 48 norm_c norms
    per_layer = 2 * (music.d_model - music.cond_dim) * music.kv_dim
    assert counts["musicgen-large"] - music.param_count() == \
        music.n_layers * per_layer + music.d_model * (music.n_layers + 1)


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
    # the conditioned and multi-codebook leaves, named
    d, ncb, V = cfg.d_model, cfg.n_codebooks, cfg.vocab_size
    assert mine["embed"]["emb"].shape == (ncb, V, d)
    if not cfg.tie_embeddings:
        assert mine["lm_head"]["w"].shape == (d, ncb * V)
    assert ("cond_proj" in mine) == bool(cfg.cond_dim)
    if cfg.cond_dim:
        assert mine["cond_proj"]["w"].shape == (cfg.cond_dim, d)
    layers = mine["groups"]["0"]
    if cfg.arch_type == "vlm":
        gate = layers["4"]["gate_attn"]
        assert gate.shape == (2,) and gate.dtype == np.float32
        assert set(layers["4"]["mixer"]["wk"]) == {"w"}
    if cfg.arch_type == "audio":
        assert {"norm_c", "cross"} <= set(layers["0"])
        assert layers["0"]["cross"]["wk"]["w"].shape == (2, d, cfg.kv_dim)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-v3-671b",
                                  "llama-3.2-vision-11b", "musicgen-large"])
def test_bf16_converted_tree_matches_init_layout(arch):
    """A bf16 model of the newer families converted from the reference
    (``convert.from_jax_numpy``) and the port's own ``init_params``: the
    same tree leaf for leaf, the MTP head included, with the same torch
    dtypes: Mamba's ``A_log``, ``D`` and ``dt_bias``, the routers and
    Llama-Vision's ``gate_attn`` float32, every other weight bf16
    (MusicGen's ``cond_proj``, conditioning sublayer and (4, V, d)
    embedding among them)."""
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    conv = from_jax_numpy(jax.device_get(
        JT.init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
    mine = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert ("mtp" in mine) == ("mtp" in conv) == cfg.mtp
    assert jax.tree.structure(mine) == jax.tree.structure(conv)
    f32 = set()
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mine),
                            jax.tree.leaves(conv)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
        if a.dtype == torch.float32:
            f32.add(jax.tree_util.keystr(path[-1:]))
    assert f32 == {
        "jamba-v0.1-52b": {"['A_log']", "['D']", "['dt_bias']", "['router']"},
        "deepseek-v3-671b": {"['router']"},
        "llama-3.2-vision-11b": {"['gate_attn']"},
        "musicgen-large": set()}[arch]


def test_large_leaves_are_drawn_in_slices(monkeypatch):
    """A leaf over ``layers.DRAW_CHUNK`` elements is drawn a slice of its
    first axis at a time (a full-size DeepSeek-V3 expert weight would hold
    14 GiB of float32 otherwise): the same shape, dtype and scale, the
    same numbers from the same seed, and a leaf under the limit drawn
    whole as before."""
    monkeypatch.setattr(L, "DRAW_CHUNK", 100)
    monkeypatch.setattr(L, "DRAW_SLICE", 70)
    draw = lambda shape: L.normal(torch.Generator().manual_seed(4), shape,  # noqa: E731
                                  0.5, dtype=torch.bfloat16, device="cpu")
    a, b = draw((9, 7, 5)), draw((9, 7, 5))
    assert a.shape == (9, 7, 5) and a.dtype == torch.bfloat16
    assert torch.equal(a, b) and 0.35 < float(a.float().std()) < 0.65
    whole = torch.randn((4, 5), generator=torch.Generator().manual_seed(4))
    assert torch.equal(draw((4, 5)), (whole * 0.5).to(torch.bfloat16))


def test_init_params_deterministic_per_seed():
    _, cfg = _cfgs("rwkv6-1.6b")
    a, b = (to_numpy(T.init_params(cfg, torch.Generator().manual_seed(s),
                                   device="cpu")) for s in (3, 3))
    jax.tree.map(np.testing.assert_array_equal, a, b)


def _caches_close(got, want, atol=ATOL):
    """Each cache leaf within ``atol`` of its own scale (its largest
    |value|, at least 1): the RWKV state sums many steps and grows to ~7,
    where float32 summation order alone moves an element by ~1.3e-5."""
    def close(g, w):
        w = np.asarray(w, np.float32)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_np(g), w, atol=atol * scale, rtol=0)
    jax.tree.map(close, got, want)


def test_prefill_and_decode_match_reference(model):
    """prefill of a 21-token prompt into a 16-slot cache (the ring wraps
    for the attention and MLA archs), then 5 decode steps: logits at 1e-5
    (``_atol``: 5e-4 for Jamba) and the caches (``_caches_close``; the
    conditioned archs' cross/cond keys and values among them) after every
    call, the same greedy token from every call (in every codebook)."""
    jcfg, cfg, jp, p = model
    atol = _atol(cfg)
    tokens = _tokens(9, 21, cfg)
    jlog, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), cache_len=16,
                              cond=_jcond(cfg, 30))
    log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), cache_len=16,
                           cond=_tcond(cfg, 30))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=atol)
    _caches_close(cache, jcache, atol)
    leaf = {"vlm": "cross", "audio": "cond"}.get(cfg.arch_type)
    if leaf:
        held = cache["0"]["4" if leaf == "cross" else "0"][leaf]
        assert held["k"].shape == (2, 1, cfg.cond_seq_len, cfg.n_kv_heads,
                                   cfg.head_dim)
    for step in range(5):
        t = 21 + step
        tok = _tokens(10 + step, 1, cfg)
        jlog, jcache = JT.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                      jnp.int32(t))
        log, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache, t)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=atol)
        np.testing.assert_array_equal(log.argmax(-1).numpy(),
                                      np.asarray(jlog).argmax(-1))
        _caches_close(cache, jcache, atol)


def test_two_images_give_different_logits():
    """Llama-Vision with its gates at 0.5: two different images (``cond``)
    give different logits on the same prompt, a prefill and a decode step
    (a port whose cross branch added nothing would fail here), each
    equal to the reference's for its image."""
    jcfg, cfg = _cfgs("llama-3.2-vision-11b")
    jp, p = _init(jcfg, 31)
    tokens = _tokens(32, 9, cfg)
    out = []
    for seed in (33, 34):
        jlog, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), cache_len=12,
                                  cond=_jcond(cfg, seed))
        log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), cache_len=12,
                               cond=_tcond(cfg, seed))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL)
        step, _ = T.decode_step(p, cfg, torch.from_numpy(tokens[:, :1]),
                                cache, 9)
        jstep, _ = JT.decode_step(jp, jcfg, jnp.asarray(tokens[:, :1]),
                                  jcache, jnp.int32(9))
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=ATOL)
        out.append((log, step))
    (a, sa), (b, sb) = out
    assert float((a - b).abs().max()) > 1e-3
    assert float((sa - sb).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-v3-671b"])
def test_windowed_hybrid_and_mla_match_reference(arch):
    """``window_attn`` reaches only the plain attention layers (Jamba's
    2 of 16), never MLA, as in the reference: prefill and decode logits
    against its windowed model."""
    jcfg, cfg = _cfgs(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(26))
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    tokens = _tokens(27, 10, cfg)
    kw = dict(cache_len=12, window_attn=4)
    jlog, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), **kw)
    log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), **kw)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=_atol(cfg))
    for t in range(10, 13):
        tok = _tokens(t, 1, cfg)
        jlog, jcache = JT.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                      jnp.int32(t), window_attn=4)
        log, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache, t,
                                   window_attn=4)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   atol=_atol(cfg))


def test_windowed_decode_matches_reference():
    jcfg, cfg = _cfgs("mistral-nemo-12b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(11))
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    tokens = _tokens(12, 10, cfg)
    jlog, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), cache_len=12,
                              window_attn=4)
    log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), cache_len=12,
                           window_attn=4)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL)
    for t in range(10, 15):
        tok = _tokens(t, 1, cfg)
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
    tokens = _tokens(24, 10, cfg)
    _, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), cache_len=16)
    _, cache = T.prefill(p, cfg, torch.from_numpy(tokens), cache_len=16)
    tok = _tokens(25, 1, cfg)
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
    jp, p = _init(jcfg, seed)
    assert p["lm_head"]["w"].dtype == torch.bfloat16
    tokens = _tokens(14, 12, cfg)
    jlog, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), cache_len=16,
                              cond=_jcond(cfg, 35))
    log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), cache_len=16,
                           cond=_tcond(cfg, 35))
    diffs = []
    for t in range(12, 16):
        assert log.dtype == torch.bfloat16
        jax.tree.map(lambda a, b: str(a.dtype).split(".")[-1] == str(b.dtype)
                     or pytest.fail(f"{a.dtype} != {b.dtype}"), cache, jcache)
        diffs.append(np.abs(_np(log) - np.asarray(jlog, np.float32)).max())
        tok = _tokens(t, 1, cfg)
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


def _bf16_track_float32(arch, seed):
    """(the port's, the reference's) largest distance of their bf16
    logits from the reference's float32 model on the same weights (the
    bf16 ones up-cast), over a prefill and 4 decode steps; every logits
    and cache leaf in the reference's dtypes. The reference's calls are
    jitted (one program per dtype and call)."""
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    p = from_jax_numpy(jax.device_get(jp), "cpu")

    def jitted(c):
        return (jax.jit(lambda q, x: JT.prefill(q, c, x, cache_len=16)),
                jax.jit(lambda q, x, cache, t: JT.decode_step(q, c, x, cache,
                                                              t)))

    (jpre, jdec), (fpre, fdec) = jitted(jcfg), jitted(jcfg32)
    tokens = _tokens(14, 12, cfg)
    jlog, jcache = jpre(jp, jnp.asarray(tokens))
    flog, fcache = fpre(jp32, jnp.asarray(tokens))
    log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), cache_len=16)
    port, ref = [], []
    for t in range(12, 17):
        assert log.dtype == torch.bfloat16
        jax.tree.map(lambda a, b: str(a.dtype).split(".")[-1] == str(b.dtype)
                     or pytest.fail(f"{a.dtype} != {b.dtype}"), cache, jcache)
        f = np.asarray(flog)
        port.append(np.abs(_np(log) - f).max())
        ref.append(np.abs(np.asarray(jlog, np.float32) - f).max())
        if t == 16:
            break
        tok = _tokens(t, 1, cfg)
        jlog, jcache = jdec(jp, jnp.asarray(tok), jcache, jnp.int32(t))
        flog, fcache = fdec(jp32, jnp.asarray(tok), fcache, jnp.int32(t))
        log, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache, t)
    return max(port), max(ref)


def test_bf16_mla_prefill_and_decode_track_reference():
    """``test_bf16_prefill_and_decode_track_reference`` for reduced
    DeepSeek (4 MLA layers, 2 of them MoE): logits within 0.1."""
    _bf16_track("deepseek-v3-671b", 13)


def test_bf16_hybrid_tracks_the_float32_model_as_the_reference_does():
    """Reduced Jamba in bf16 is no model for a 0.1 bound: its selective
    scans read dt, B and C rounded to bf16, and exp(dt A) with A down to
    -16 turns one bf16 step of dt into several percent of a decay, so the
    reference's OWN bf16 logits lie 0.78-2.45 from its float32 model on
    the same weights at their worst call (measured over seeds 13-18;
    logits up to ~3.3), and the port's 0.66-2.19. So each side is held to
    the float32 model: the port's bf16 logits no further from it than 3x
    the reference's bf16 logits are (measured ratio over seeds 13-18:
    0.75, 0.56, 0.47, 1.05, 0.47, 2.82), logits and every cache leaf, the
    float32 Mamba state among them, in the reference's dtypes. The
    layer-level cast points are ``tests/test_torch_ssm.py``'s, where the
    two sides agree to a quarter of a bf16 step."""
    port, ref = _bf16_track_float32("jamba-v0.1-52b", 13)
    assert port <= 3 * ref, (port, ref)


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


def _n_attn(cfg):
    """The plain attention layers, the ones the flash kernel serves."""
    return sum(count * sum(s.mixer == "attn" for s in specs)
               for specs, count in cfg.groups)


@pytest.mark.parametrize("arch, dtype, window", [
    ("olmoe-1b-7b", "float32", 0), ("mistral-nemo-12b", "float32", 0),
    ("olmoe-1b-7b", "bfloat16", 0), ("mistral-nemo-12b", "bfloat16", 0),
    ("mistral-nemo-12b", "float32", 5), ("jamba-v0.1-52b", "float32", 0),
    ("deepseek-v3-671b", "float32", 0),
    ("llama-3.2-vision-11b", "float32", 0), ("musicgen-large", "float32", 0)])
def test_prefill_pallas_switch_matches_reference(arch, dtype, window):
    """``prefill(kernel="pallas")`` against the reference's, which runs
    its Pallas flash kernel in interpret mode here: float32 logits and
    caches at 1e-5 (Jamba: 5e-4), bf16 logits (largest ~3.6) within the
    bf16 test's 0.1 (measured: 0.023 for Mistral and OLMoE, where the
    reference's Pallas and plain prefills agree bit for bit). The
    prompt's attention goes through the flash wrapper once a plain
    attention layer (Jamba: 2 of its 16; DeepSeek's MLA never, as the
    reference's MLA ignores the switch; Llama-Vision 8 of its 10, its
    cross-attention layers never, nor MusicGen's conditioning sublayers,
    as the reference's cross-attention ignores it), and on the CPU its
    plain version makes the switch bit-equal to the port's ``"jnp"``
    prefill."""
    from repro_torch.kernels import flash_attention as FA
    jcfg, cfg = _cfgs(arch, dtype=dtype)
    jp, p = _init(jcfg, 21)
    tokens = _tokens(22, 12, cfg)
    kw = dict(cache_len=16, window_attn=window)
    jlog, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), kernel="pallas",
                              cond=_jcond(cfg, 36), **kw)
    calls = FA.flash_attention.calls
    log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), kernel="pallas",
                           cond=_tcond(cfg, 36), **kw)
    assert FA.flash_attention.calls == calls + _n_attn(cfg)
    assert _n_attn(cfg) == {"jamba-v0.1-52b": 2, "deepseek-v3-671b": 0,
                            "llama-3.2-vision-11b": 8}.get(arch, cfg.n_layers)
    plain, plain_cache = T.prefill(p, cfg, torch.from_numpy(tokens),
                                   cond=_tcond(cfg, 36), **kw)
    assert torch.equal(log, plain)
    jax.tree.map(lambda a, b: torch.equal(a, b) or pytest.fail("cache"),
                 cache, plain_cache)
    if dtype == "float32":
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   atol=_atol(cfg))
        _caches_close(cache, jcache, _atol(cfg))
    else:
        assert log.dtype == torch.bfloat16
        diff = np.abs(_np(log) - np.asarray(jlog, np.float32)).max()
        assert diff <= 0.1, diff


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b", "deepseek-v3-671b",
                                  "llama-3.2-vision-11b", "musicgen-large"])
def test_kernel_calls_follow_the_mixers(arch):
    """A prefill and two decode steps call decode attention once a plain
    attention layer a step (Jamba 2 of 16; MLA's absorbed decode never,
    as no Pallas kernel serves it in the reference either; Llama-Vision 8
    of 10, its cross layers never, nor MusicGen's conditioning
    sublayers) and the RWKV6 scan once an RWKV6 layer a call: the counts
    a card run's launches are held to (``chip_smoke.py``'s
    ``want_launches``)."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import rwkv6 as RW
    _, cfg = _cfgs(arch)
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = (DA.decode_attention.calls, RW.rwkv6_scan.calls)
    _, cache = T.prefill(p, cfg, torch.from_numpy(_tokens(29, 6, cfg)),
                         cache_len=8, cond=_tcond(cfg, 37))
    for t in (6, 7):
        T.decode_step(p, cfg, torch.from_numpy(_tokens(t, 1, cfg)), cache, t)
    calls = (DA.decode_attention.calls - before[0],
             RW.rwkv6_scan.calls - before[1])
    assert calls == (2 * _n_attn(cfg), 3 * sum(
        n * sum(s.mixer == "rwkv6" for s in specs) for specs, n in cfg.groups))
    assert calls == {"mistral-nemo-12b": (4, 0), "rwkv6-1.6b": (0, 6),
                     "jamba-v0.1-52b": (4, 0),
                     "deepseek-v3-671b": (0, 0),
                     "llama-3.2-vision-11b": (16, 0),
                     "musicgen-large": (4, 0)}[arch]
    assert (DA.decode_attention.launches, RW.rwkv6_scan.launches) == (0, 0)


def test_unported_parts_name_roadmap_item():
    """What the zoo once refused (a ``cross_attn`` mixer, a ``spec.cross``
    sublayer, a conditioning frontend) now builds and runs in any
    config, as in the reference: reduced Mistral-NeMo with a gated
    cross-attention layer, and with the conditioning sublayer on its
    self-attention layer, each conditioned on 8 x 32 features, prefill
    and a decode step at 1e-5 against the reference's. Only names that
    are no layer at all are refused (ValueError, as the reference's
    ``init_layer``), and a conditioned model refuses a prompt without its
    ``cond``."""
    jbase, base = (reduced(c("mistral-nemo-12b")) for c in (jget_config,
                                                              get_config))
    for change in (dict(mixer="cross_attn"), dict(cross=True)):
        def cfg_of(c):
            spec = dataclasses.replace(c.groups[0][0][0], **change)
            return dataclasses.replace(c, groups=(((c.groups[0][0][0], spec),
                                                   1),),
                                       n_layers=2, cond_seq_len=8,
                                       cond_dim=32)
        jcfg, cfg = cfg_of(jbase), cfg_of(base)
        jp, p = _init(jcfg, 38)
        tokens = _tokens(39, 7, cfg)
        jlog, jcache = JT.prefill(jp, jcfg, jnp.asarray(tokens), cache_len=8,
                                  cond=_jcond(cfg, 40))
        log, cache = T.prefill(p, cfg, torch.from_numpy(tokens), cache_len=8,
                               cond=_tcond(cfg, 40))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL)
        jlog, _ = JT.decode_step(jp, jcfg, jnp.asarray(tokens[:, :1]), jcache,
                                 jnp.int32(7))
        log, _ = T.decode_step(p, cfg, torch.from_numpy(tokens[:, :1]), cache,
                               7)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL)
        with pytest.raises(ValueError, match="pass cond="):
            T.prefill(p, cfg, torch.from_numpy(tokens))
    bad = dataclasses.replace(base, groups=(((dataclasses.replace(
        base.groups[0][0][0], mixer="lstm"),), 1),))
    with pytest.raises(ValueError, match="mixer 'lstm'"):
        T.init_params(bad, torch.Generator(), device="cpu")


# ----------------------------------------------------------------- server

SYSTEM_PROMPT = np.arange(1, 33, dtype=np.int32)
MIX_COND = 41          # the seed of the mix's one conditioning input


def _req(request_cls, cfg, rid, tokens, cond_seed=MIX_COND, **kw):
    """A request of ``cfg``'s form: ``tokens`` (S,) as its prompt
    (``codebooks``), with the seeded ``cond`` of a conditioned arch."""
    return request_cls(rid, codebooks(cfg, np.asarray(tokens, np.int32)),
                       cond=stub_cond(cfg, cond_seed), **kw)


def _again(request_cls, cfg):
    """The system prompt again: a prompt identical to a stored one."""
    return _req(request_cls, cfg, "again", SYSTEM_PROMPT, max_new_tokens=3)


def _llm_generate_mix(server_cls, request_cls, srv):
    """The mix of examples/llm_generate.py: a 32-token system prompt, then
    4 users of +2 tokens, 8 new tokens each; then the exact repeat. A
    conditioned arch's requests share one ``cond``."""
    cfg = srv.cfg
    out = [srv.serve_one(_req(request_cls, cfg, "warm", SYSTEM_PROMPT,
                              max_new_tokens=1))]
    for i in range(4):
        u = np.array([40 + i, 50 + i], np.int32)
        out.append(srv.serve_one(_req(request_cls, cfg, f"u{i}",
                                      np.concatenate([SYSTEM_PROMPT, u]),
                                      max_new_tokens=8)))
    out.append(srv.serve_one(_again(request_cls, cfg)))
    return out


def _same_results(res, jres):
    for a, b in zip(res, jres, strict=True):
        assert (a.rid, a.prefix_hit, a.prefill_tokens) == \
            (b.rid, b.prefix_hit, b.prefill_tokens)
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.tokens.dtype == np.int32


def test_server_matches_reference_server(model):
    """Results and stats equal the reference server's, with one row held
    to another server: the exact repeat ("again"). The reference decodes
    such a prompt's last token a second time to get logits, which folds
    it into a recurrent state (RWKV6, Mamba) twice; the port reuses the
    stored logits, so its row equals what the reference's COLD server
    (``enable_prefix_cache=False``) returns for that prompt. The stats
    are the reference's warm server's: it never counted that decode.
    MusicGen's results are (n, 4) tokens."""
    jcfg, cfg, jp, p = model
    jsrv = JServer(jcfg, jp, cache_len=96)
    jres = _llm_generate_mix(JServer, JRequest, jsrv)
    srv = LLMServer(cfg, p, cache_len=96, device="cpu")
    res = _llm_generate_mix(LLMServer, Request, srv)
    assert srv.stats == jsrv.stats
    assert srv.stats["prefix_hits"] == 5
    _same_results(res[:-1], jres[:-1])
    assert res[1].tokens.shape == (8,) + ((cfg.n_codebooks,)
                                          if cfg.n_codebooks > 1 else ())
    jsrv.enable_prefix_cache = False     # now a cold server, its programs built
    np.testing.assert_array_equal(
        res[-1].tokens,
        np.asarray(jsrv.serve_one(_again(JRequest, jcfg)).tokens))
    assert (res[-1].prefix_hit, res[-1].prefill_tokens) == \
        (jres[-1].prefix_hit, jres[-1].prefill_tokens) == (True, 0)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large"])
def test_new_cond_misses_the_prefix_cache(arch):
    """The reference keys a stored prompt on its tokens alone, so the
    same or a longer prompt with a new ``cond`` hits and is answered from
    the first input's cross keys and values. The port keys on ``cond``
    too: both requests miss, are prefilled whole, and equal a cold
    reference server's answers for their own ``cond``; the first input's
    repeat still hits. Llama-Vision's gates at 0.5."""
    jcfg, cfg = _cfgs(arch)
    jp, p = _init(jcfg, 42)
    longer = np.concatenate([SYSTEM_PROMPT, [60, 61]])
    reqs = lambda cls: [  # noqa: E731
        _req(cls, cfg, "first", SYSTEM_PROMPT, max_new_tokens=4),
        _req(cls, cfg, "same", SYSTEM_PROMPT, cond_seed=43, max_new_tokens=6),
        _req(cls, cfg, "longer", longer, cond_seed=44, max_new_tokens=6),
        _req(cls, cfg, "repeat", longer[:-1], max_new_tokens=3)]
    srv = LLMServer(cfg, p, cache_len=48, device="cpu")
    res = srv.serve(reqs(Request))
    assert [(r.prefix_hit, r.prefill_tokens) for r in res] == [
        (False, 32), (False, 32), (False, 34), (True, 1)]
    cold = JServer(jcfg, jp, cache_len=48, enable_prefix_cache=False)
    _same_results(res, [dataclasses.replace(r, prefix_hit=h, prefill_tokens=n)
                        for r, (h, n) in zip(cold.serve(reqs(JRequest)),
                                             [(False, 32), (False, 32),
                                              (False, 34), (True, 1)])])
    warm = JServer(jcfg, jp, cache_len=48)     # the reference's fault
    assert [r.prefix_hit for r in warm.serve(reqs(JRequest))] == \
        [False, True, True, True]


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "jamba-v0.1-52b"])
def test_server_window_and_list_serve_match_reference(arch):
    """``LLMServer(batch_size=1, window=6)`` served through the list form
    ``serve([...])``: results and stats equal the reference's windowed
    server's (the exact repeat against its cold one, as above), the
    window masks prefill and decode alike, and ``batch_size`` is stored
    as ``B``."""
    jcfg, cfg = _cfgs(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(28))
    p = from_jax_numpy(jax.device_get(jp), "cpu")
    kw = dict(batch_size=1, cache_len=48, window=6)
    reqs = lambda cls: [  # noqa: E731
        cls("a", SYSTEM_PROMPT[:20], max_new_tokens=6),
        cls("b", np.concatenate([SYSTEM_PROMPT[:20], [60, 61, 62]]).astype(
            np.int32), max_new_tokens=9),
        cls("again", SYSTEM_PROMPT[:20], max_new_tokens=4)]
    jsrv = JServer(jcfg, jp, **kw)
    jres = jsrv.serve(reqs(JRequest))
    srv = LLMServer(cfg, p, device="cpu", **kw)
    res = srv.serve(reqs(Request))
    assert (srv.B, srv.window) == (1, 6) and srv.stats == jsrv.stats
    _same_results(res[:-1], jres[:-1])
    jsrv.enable_prefix_cache = False     # now a cold server, its programs built
    np.testing.assert_array_equal(
        res[-1].tokens, np.asarray(jsrv.serve(reqs(JRequest)[-1:])[0].tokens))
    unwindowed = LLMServer(cfg, p, cache_len=48, device="cpu").serve(
        reqs(Request))
    assert any(not np.array_equal(a.tokens, b.tokens)
               for a, b in zip(res, unwindowed))


def test_server_refuses_conditioning_inputs():
    """``Request.cond`` goes only to an arch with a conditioning frontend:
    Mistral-NeMo refuses one, Llama-Vision refuses a request without
    one, and MusicGen refuses a prompt without its codebook axis."""
    for arch, req in (
            ("mistral-nemo-12b", Request("c", SYSTEM_PROMPT[:4],
                                         cond=np.zeros((2, 8), np.float32))),
            ("llama-3.2-vision-11b", Request("c", SYSTEM_PROMPT[:4])),
            ("musicgen-large", Request("c", SYSTEM_PROMPT[:4], cond=np.zeros(
                (8, 32), np.float32)))):
        _, cfg = _cfgs(arch)
        p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        srv = LLMServer(cfg, p, cache_len=16, device="cpu")
        with pytest.raises(ValueError, match="cond|prompt of 2 dims"):
            srv.serve_one(req)


def test_eos_stops_like_the_reference(model):
    """A request stops at its eos token, as the reference's server does
    (MusicGen: when every codebook gives it, which random weights never
    do here, so it runs on, as the reference's)."""
    jcfg, cfg, jp, p = model
    prompt = np.arange(3, 20, dtype=np.int32)
    free = JServer(jcfg, jp, cache_len=48).serve_one(
        _req(JRequest, jcfg, "free", prompt, max_new_tokens=8))
    eos = int(np.asarray(free.tokens)[2].flat[0])
    want = JServer(jcfg, jp, cache_len=48)
    got = LLMServer(cfg, p, cache_len=48, device="cpu")
    a = got.serve_one(_req(Request, cfg, "eos", prompt, max_new_tokens=8,
                           eos_id=eos))
    b = want.serve_one(_req(JRequest, jcfg, "eos", prompt, max_new_tokens=8,
                            eos_id=eos))
    np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
    if cfg.n_codebooks == 1:
        assert len(a.tokens) <= 3 and a.tokens[-1] == eos
    else:
        assert len(a.tokens) == 8 or np.all(a.tokens[-1] == eos)
    assert got.stats == want.stats


def test_codebook_eos_waits_for_every_codebook():
    """MusicGen stops at ``eos_id`` only when every codebook gives it
    (the reference's ``np.all(val == eos_id)``): both servers' greedy
    picks replaced by the same script, three codebooks at eos from the
    first token and the fourth from the third, and both stop after the
    third token."""
    jcfg, cfg = _cfgs("musicgen-large")
    jp, p = _init(jcfg, 45)
    script = [[7, 7, 7, 9], [7, 7, 7, 9], [7, 7, 7, 7], [1, 2, 3, 4]]

    def scripted(srv, to):
        calls = []
        srv._greedy = lambda logits: calls.append(0) or to(
            [[script[len(calls) - 1]]])

    got = LLMServer(cfg, p, cache_len=48, device="cpu")
    scripted(got, lambda a: torch.tensor(a, dtype=torch.int64))
    want = JServer(jcfg, jp, cache_len=48)
    scripted(want, lambda a: jnp.asarray(a, jnp.int32))
    a = got.serve_one(_req(Request, cfg, "eos", SYSTEM_PROMPT[:6],
                           max_new_tokens=8, eos_id=7))
    b = want.serve_one(_req(JRequest, jcfg, "eos", SYSTEM_PROMPT[:6],
                            max_new_tokens=8, eos_id=7))
    np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
    np.testing.assert_array_equal(a.tokens, script[:3])
    assert got.stats == want.stats


def test_prefix_hit_tokens_equal_a_cold_server(model):
    """Every prefix hit, the exact repeat included, returns a cold
    server's tokens."""
    _, cfg, _, p = model
    warm = LLMServer(cfg, p, cache_len=96, device="cpu")
    cold = LLMServer(cfg, p, cache_len=96, device="cpu",
                     enable_prefix_cache=False)
    res = _llm_generate_mix(LLMServer, Request, warm)
    ref = _llm_generate_mix(LLMServer, Request, cold)
    assert cold.stats["prefix_hits"] == 0
    for a, b in zip(res[1:], ref[1:], strict=True):
        assert a.prefix_hit and not b.prefix_hit
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_exact_hit_decodes_nothing_and_keeps_the_state(arch):
    """An exact repeat on a recurrent arch: no decode step runs, the
    server's static cache equals the stored snapshot afterwards (the
    reference's re-decode would have stepped the state once more), and
    the first token equals the cold prefill's."""
    _, cfg = _cfgs(arch)
    p = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    srv = LLMServer(cfg, p, cache_len=48, device="cpu")
    first = srv.serve_one(Request("sys", SYSTEM_PROMPT, max_new_tokens=1))
    steps = []
    decode = srv._decode
    srv._decode = lambda *a: steps.append(a) or decode(*a)
    again = srv.serve_one(Request("again", SYSTEM_PROMPT, max_new_tokens=1))
    assert steps == [] and again.prefix_hit and again.prefill_tokens == 0
    np.testing.assert_array_equal(again.tokens, first.tokens)
    (stored, _), = srv.prefix_cache.values()
    jax.tree.map(lambda a, b: torch.equal(a, b) or pytest.fail("state"),
                 srv._state["cache"], stored)


def test_stored_prefix_entry_unchanged_by_later_hits(model):
    """The port decodes in place; a stored entry must stay a snapshot."""
    _, cfg, _, p = model
    srv = LLMServer(cfg, p, cache_len=48, device="cpu")
    system_prompt = np.arange(1, 17, dtype=np.int32)
    srv.serve_one(_req(Request, cfg, "sys", system_prompt, max_new_tokens=4))
    (key, (entry, _)), = srv.prefix_cache.items()
    before = jax.tree.map(lambda a: a.clone(), entry)
    for i in range(3):
        r = srv.serve_one(_req(Request, cfg, f"u{i}", np.concatenate(
            [system_prompt, [60 + i]]), max_new_tokens=5))
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
    # MusicGen, conditioned on its stub text features: (S, 4) prompts and
    # a completion of 4-codebook rows, the one line's format
    main(["--device", "cpu", "--arch", "musicgen-large"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("musicgen-large ")
    assert "4/4 prefix hits, encoded 8 vs 136" in out[0]
    assert "first completion: [[" in out[0] and out[0].endswith("on cpu")
    with pytest.raises(SystemExit, match="unknown arch"):
        main(["--device", "cpu", "--arch", "gpt-5"])
