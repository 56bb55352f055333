"""EMSNet in the port against the JAX reference, on the CPU.

Weights come from the JAX initialiser and pass through numpy into the
port (``repro_torch.convert``); inputs are numpy arrays from a seed. The
JAX flash path runs its Pallas kernel in interpret mode, as the JAX
package's own tests do; the port's wrapper takes the plain PyTorch
version on CPU tensors. atol 1e-5 is the float32 tolerance the JAX
engine tests use for model outputs.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.emsnet import tiny as jax_tiny
from repro.models import emsnet as JE
from repro.models import layers as JL
from repro_torch.configs.emsnet import tiny
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.models import emsnet as E
from repro_torch.models import layers as L

ATOL = 1e-5
MODS = ("text", "vitals", "scene")
SUBSETS = [s for r in (1, 2, 3) for s in itertools.combinations(MODS, r)]


def _params(jcfg, seed=0):
    jp = JE.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, from_jax_numpy(jax.device_get(jp), "cpu")


def _tokens(cfg, seed=0):
    """Rows of different lengths with PAD suffixes, one all-PAD row."""
    rng = np.random.default_rng(seed)
    S = cfg.max_text_len
    toks = rng.integers(1, cfg.vocab_size, (4, S)).astype(np.int32)
    for i, n in enumerate([S, S // 2, 1, 0]):
        toks[i, n:] = 0
    return toks


def _vitals(cfg, seed=0, T=None):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(3, T or cfg.vitals_len, cfg.n_vitals)).astype(np.float32)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed + 1)
    return {"text": _tokens(cfg, seed), "vitals": _vitals(cfg, seed, T=5)[:1]
            .repeat(4, 0),
            "scene": rng.integers(0, 2, (4, cfg.scene_dim)).astype(np.float32)}


def _close(got, want, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], atol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# ------------------------------------------------------------ conversion

def test_converter_round_trip_keeps_keys_layout_and_values():
    jp, tp = _params(jax_tiny(text_encoder="microbert"))
    back = to_numpy(tp)
    ref = jax.device_get(jp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert isinstance(tp["text"]["blocks"], list)
    assert tp["text"]["blocks"][0]["wqkv"]["w"].shape == (64, 3 * 64)


@pytest.mark.parametrize("text_encoder", ["microbert", "tinybert"])
@pytest.mark.parametrize("vitals_encoder", ["rnn", "gru", "lstm"])
def test_port_init_has_reference_structure(text_encoder, vitals_encoder):
    kw = dict(text_encoder=text_encoder, vitals_encoder=vitals_encoder)
    ref = jax.device_get(JE.init_params(jax_tiny(**kw), jax.random.PRNGKey(0)))
    mine = to_numpy(E.init_params(tiny(**kw), torch.Generator().manual_seed(0),
                                  device="cpu"))
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_init_is_seeded_and_device_independent():
    cfg = tiny(text_encoder="microbert")
    a = to_numpy(E.init_params(cfg, torch.Generator().manual_seed(3),
                               device="cpu"))
    b = to_numpy(E.init_params(cfg, torch.Generator().manual_seed(3),
                               device="cpu"))
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- layers

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 12)).astype(np.float32) * 3 + 1
    p = {"w": rng.normal(size=(12, 7)).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(np.float32)}
    ln = {"scale": rng.normal(size=(12,)).astype(np.float32),
          "bias": rng.normal(size=(12,)).astype(np.float32)}
    emb = {"emb": rng.normal(size=(20, 12)).astype(np.float32)}
    toks = rng.integers(0, 20, (2, 6)).astype(np.int32)
    t = lambda tree: from_jax_numpy(tree, "cpu")  # noqa: E731
    _close(L.dense(t(p), torch.from_numpy(x)), JL.dense(p, x))
    _close(L.layernorm(t(ln), torch.from_numpy(x)), JL.layernorm(ln, x))
    _close(L.embed(t(emb), torch.from_numpy(toks)), JL.embed(emb, toks))


def _dense_leaves():
    from repro.models import quantized as JQ
    from repro_torch.models import quantized as PQ
    rng = np.random.default_rng(5)
    p = {"w": rng.normal(size=(24, 10)).astype(np.float32) / 5,
         "b": rng.normal(size=(10,)).astype(np.float32)}
    jleaf = JQ.quantize_dense_params({k: jnp.asarray(v) for k, v in p.items()})
    leaf = PQ.quantize_dense_params({k: torch.from_numpy(v)
                                     for k, v in p.items()})
    return jleaf, leaf, rng


def test_quantized_dense_leaf_matches_reference():
    """An int8 sidecar leaf runs through the quantized GEMM as JAX's dense
    runs it (bias added after)."""
    jleaf, leaf, rng = _dense_leaves()
    x = rng.normal(size=(2, 3, 24)).astype(np.float32)
    _close(L.dense(leaf, torch.from_numpy(x)), JL.dense(jleaf, jnp.asarray(x)))


def test_quantized_dense_leaf_is_refused():
    """A quantized leaf whose contraction does not match the input is
    refused."""
    _jleaf, leaf, _rng = _dense_leaves()
    with pytest.raises(ValueError, match="contraction mismatch"):
        L.dense(leaf, torch.zeros((1, 23)))


# ---------------------------------------------------------------- encoders

TEXT_MODES = {
    "flash_kv_lengths": dict(use_flash_text=True),
    "flash_segments": dict(use_flash_text=True, flash_segments=True),
    "einsum": dict(use_flash_text=False),
}


@pytest.mark.parametrize("text_encoder", ["microbert", "tinybert"])
@pytest.mark.parametrize("mode", sorted(TEXT_MODES))
def test_text_encoder_matches_reference(mode, text_encoder):
    kw = dict(TEXT_MODES[mode], text_encoder=text_encoder)
    jcfg, cfg = jax_tiny(**kw), tiny(**kw)
    jp, tp = _params(jcfg)
    toks = _tokens(cfg)
    if mode == "flash_segments":
        toks = toks[:, :13]        # S=13 pads to 16 inside both encoders
    want = JE.text_encoder(jp["text"], jcfg, jnp.asarray(toks))
    got = E.text_encoder(tp["text"], cfg, torch.from_numpy(toks))
    assert got.shape == (4, cfg.feature_dims["text"])
    _close(got, want)


def test_port_flash_text_equals_einsum_on_padded_batch():
    """The port's two text paths agree, all-PAD row included (the
    reference's tests/test_batch_serving.py check, held in the port)."""
    cfg = tiny(text_encoder="microbert")
    _, tp = _params(jax_tiny(text_encoder="microbert"))
    toks = torch.from_numpy(_tokens(cfg)[:3])
    a = E.text_encoder(tp["text"], cfg, toks)
    b = E.text_encoder(tp["text"], tiny(text_encoder="microbert",
                                        use_flash_text=False), toks)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


@pytest.mark.parametrize("text_encoder", ["microbert", "tinybert"])
def test_flash_kv_lengths_text_with_interior_pads_matches_einsum(
        text_encoder):
    """The synthetic NEMSIS text drops words anywhere in a row (interior
    PADs): the port's ``kv_lengths`` flash path reorders each row's valid
    tokens first and agrees with the reference's einsum path at the
    flash-vs-einsum tolerance, one flash call a block."""
    from repro_torch.data import synthetic_nemsis as SN
    from repro_torch.kernels import flash_attention as FA
    jcfg = jax_tiny(text_encoder=text_encoder, use_flash_text=False)
    cfg = tiny(text_encoder=text_encoder, use_flash_text=True)
    jp, tp = _params(jcfg)
    toks = SN.generate(cfg, 32, seed=3).text
    valid = toks > 0
    assert (~valid[:, :-1] & valid[:, 1:]).any(1).sum() >= 16
    want = JE.text_encoder(jp["text"], jcfg, jnp.asarray(toks))
    calls = FA.flash_attention.calls
    got = E.text_encoder(tp["text"], cfg, torch.from_numpy(toks))
    assert FA.flash_attention.calls - calls == len(tp["text"]["blocks"])
    _close(got, want)


def test_flash_kv_lengths_suffix_rows_unchanged_by_the_reordering():
    """Rows whose PADs are a suffix keep their order: the features are
    bit for bit those of the path without the reordering (the blocks run
    on the embedded rows as they are, keys masked by ``kv_lengths``)."""
    cfg = tiny(text_encoder="tinybert", use_flash_text=True)
    _, tp = _params(jax_tiny(text_encoder="tinybert", use_flash_text=True))
    toks = torch.from_numpy(_tokens(cfg))
    p = tp["text"]
    mask = toks > 0
    x = L.embed(p["tok"], toks) + p["pos"]["emb"][None, :toks.shape[1]]
    lengths = mask.sum(-1).to(torch.int32)
    for blk in p["blocks"]:
        x = E._bert_block(blk, x, mask, cfg.text_dims[2], kv_lengths=lengths)
    want = E._pool(L.layernorm(p["ln"], x), mask)
    assert torch.equal(E.text_encoder(p, cfg, toks), want)


@pytest.mark.parametrize("kind", ["rnn", "gru", "lstm"])
@pytest.mark.parametrize("bucketed", [False, True])
def test_vitals_encoder_matches_reference(kind, bucketed):
    jcfg, cfg = jax_tiny(vitals_encoder=kind), tiny(vitals_encoder=kind)
    jp, tp = _params(jcfg)
    x = _vitals(cfg, seed=1)
    if bucketed:
        lens = np.array([8, 5, 0], np.int32)
        xp = np.concatenate([x, np.zeros_like(x)], axis=1)   # T 8 -> 16
        for i, n in enumerate(lens):
            xp[i, n:] = 0.0
        want = JE.vitals_encoder(jp["vitals"], jcfg,
                                 {"x": jnp.asarray(xp), "len": jnp.asarray(lens)})
        got = E.vitals_encoder(tp["vitals"], cfg,
                               {"x": torch.from_numpy(xp),
                                "len": torch.from_numpy(lens)})
        assert float(got[2].abs().max()) == 0.0    # len 0: the zero state
    else:
        want = JE.vitals_encoder(jp["vitals"], jcfg, jnp.asarray(x))
        got = E.vitals_encoder(tp["vitals"], cfg, torch.from_numpy(x))
    _close(got, want)


def test_bucketed_vitals_equal_unpadded_rows():
    cfg = tiny()
    _, tp = _params(jax_tiny())
    x = _vitals(cfg, seed=2)
    full = E.vitals_encoder(tp["vitals"], cfg, torch.from_numpy(x))
    xp = torch.from_numpy(np.concatenate([x, np.zeros_like(x)], axis=1))
    padded = E.vitals_encoder(tp["vitals"], cfg, {
        "x": xp, "len": torch.full((3,), 8, dtype=torch.int32)})
    np.testing.assert_allclose(padded.numpy(), full.numpy(), atol=1e-6)


def test_scene_encoder_matches_reference():
    jp, tp = _params(jax_tiny())
    s = np.random.default_rng(0).integers(0, 2, (5, 3)).astype(np.float32)
    _close(E.scene_encoder(tp["scene"], tiny(), torch.from_numpy(s)),
           JE.scene_encoder(jp["scene"], jax_tiny(), jnp.asarray(s)))


def test_ragged_payloads_wait_for_the_batch_engine():
    """The ragged packed payloads the batch engine builds go through the
    ragged forms of both encoders: one feature row per packed row, as
    the reference computes them from its own pack."""
    from repro.core.bucketing import RaggedBatch as JR
    from repro_torch.core.bucketing import RaggedBatch
    cfg = tiny()
    jp, tp = _params(jax_tiny())
    rng = np.random.default_rng(3)
    toks = [rng.integers(1, cfg.vocab_size, (1, n)).astype(np.int32)
            for n in (3, 9)]
    vit = [rng.normal(size=(1, n, cfg.n_vitals)).astype(np.float32)
           for n in (2, 5)]
    for m, rows, enc, jenc in (("text", toks, E.text_encoder,
                                JE.text_encoder),
                               ("vitals", vit, E.vitals_encoder,
                                JE.vitals_encoder)):
        got = enc(tp[m], cfg, RaggedBatch().pack(m, rows))
        want = jenc(jp[m], jax_tiny(),
                    JR().pack(m, [jnp.asarray(r) for r in rows]))
        assert got.shape == (2, cfg.feature_dims[m])
        _close(got, want)


# ---------------------------------------------------------- whole model

@pytest.fixture(scope="module")
def micro():
    kw = dict(text_encoder="microbert", use_flash_text=True)
    jcfg, cfg = jax_tiny(**kw), tiny(**kw)
    jp, tp = _params(jcfg, seed=4)
    b = _batch(cfg, seed=4)
    jb = {m: jnp.asarray(x) for m, x in b.items()}
    tb = {m: torch.from_numpy(x) for m, x in b.items()}
    return jcfg, cfg, jp, tp, jb, tb


def test_forward_matches_reference(micro):
    jcfg, cfg, jp, tp, jb, tb = micro
    want = JE.forward(jp, jcfg, jb)
    got = E.forward(tp, cfg, tb)
    _close(got, want)
    assert got["quantity"].shape == (4,)


@pytest.mark.parametrize("subset", SUBSETS, ids="+".join)
def test_partial_forward_matches_reference(micro, subset):
    jcfg, cfg, jp, tp, jb, tb = micro
    _close(E.partial_forward(tp, cfg, tb, subset),
           JE.partial_forward(jp, jcfg, jb, subset))


def test_partial_forward_full_set_is_forward(micro):
    _, cfg, _, tp, _, tb = micro
    a = E.partial_forward(tp, cfg, tb, MODS)
    b = E.forward(tp, cfg, tb)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_slice_heads_matches_reference(micro):
    jcfg, cfg, jp, tp, _, _ = micro
    for subset in SUBSETS:
        _close(E.slice_heads(tp["heads"], cfg, MODS, subset),
               JE.slice_heads(jp["heads"], jcfg, MODS, subset), atol=0)
