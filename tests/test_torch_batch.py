"""The port's flush path (batch, ragged, grouped tails) against the JAX
reference, on the CPU.

The same numpy inputs go through both packages, with the JAX
initialiser's weights converted through numpy. Each session's payloads
get their own lengths (text 1-20 tokens against a 16-token table,
vitals 1-11 steps), so several buckets are live, crops happen and the
packed buffers have gaps.

Tolerances:
  * layouts (``stack_bucketed``, ``RaggedBatch.pack``, histograms) are
    integer and index data: held exactly;
  * encoders, tails and engine outputs are float32 on both sides, summed
    in another order (XLA's einsum against the port's flash plain
    version and eager GEMMs): 1e-5, the reference's own tolerance for
    its float32 engine parity (``tests/test_batch_serving.py``);
  * flush counts, call counts, events and the padding-tax account are
    counted from shapes: exact (the tax to 1e-12 relative, a float sum);
  * the port's own invariants (ragged against bucketed, coalescing):
    1e-5. The reference pins them at atol 0, and its own bitwise ragged
    tests fail on this tree (ROADMAP queue 3); the port's packed rows sum
    in another order than a row alone, so only float32 agreement holds.
"""
import zlib
from itertools import combinations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs.emsnet import tiny as jax_tiny
from repro.core import bucketing as JB
from repro.models import emsnet as JE
from repro.serving import api as JA
from repro_torch import core as P
from repro_torch.configs.emsnet import tiny
from repro_torch.convert import from_jax_numpy
from repro_torch.core import bucketing as PB
from repro_torch.kernels import ops
from repro_torch.models import emsnet as PE
from repro_torch.serving import api as PA
from repro_torch.serving.batch_engine import BatchedEMSServe

ATOL = 1e-5
TEXT = "microbert"
ALL = ("text", "vitals", "scene")


def _cfgs(**kw):
    kw.setdefault("text_encoder", TEXT)
    return jax_tiny(**kw), tiny(**kw)


@pytest.fixture(scope="module")
def indep():
    """Independently parameterised m1/m2/m3 (the batch engine regime)."""
    jcfg, cfg = _cfgs()
    mods = {"m1": ("text",), "m2": ("text", "vitals"),
            "m3": ("text", "vitals", "scene")}
    jsplits = {k: J.split(J.emsnet_module(jcfg, m)) for k, m in mods.items()}
    key = jax.random.PRNGKey(0)
    jparams = {k: jax.jit(s.module.init_fn)(jax.random.fold_in(key, i))
               for i, (k, s) in enumerate(jsplits.items())}
    psplits = {k: P.split(P.emsnet_module(cfg, m)) for k, m in mods.items()}
    pparams = {k: from_jax_numpy(jax.device_get(p), "cpu")
               for k, p in jparams.items()}
    return cfg, (jsplits, jparams), (psplits, pparams)


@pytest.fixture(scope="module")
def zoo():
    """The 7-model subset zoo over ONE shared parameter dict."""
    jcfg, cfg = _cfgs()
    jzoo = J.emsnet_zoo(jcfg)
    jsplits = {k: J.split(m) for k, m in jzoo.items()}
    jshared = jax.jit(jzoo["text+vitals+scene"].init_fn)(
        jax.random.PRNGKey(0))
    psplits = {k: P.split(m) for k, m in P.emsnet_zoo(cfg).items()}
    pshared = from_jax_numpy(jax.device_get(jshared), "cpu")
    return (cfg, (jsplits, {k: jshared for k in jsplits}),
            (psplits, {k: pshared for k in psplits}), jshared, pshared)


def _payload(cfg, sid, ev):
    """A numpy payload of its own length for each (session, event)."""
    r = np.random.default_rng(zlib.crc32(f"{sid}:{ev.modality}:"
                                         f"{ev.index}".encode()))
    if ev.modality == "text":
        n = int(r.integers(1, cfg.max_text_len + 5))
        return r.integers(1, cfg.vocab_size, (1, n)).astype(np.int32)
    if ev.modality == "vitals":
        n = int(r.integers(1, cfg.vitals_len + 4))
        return r.normal(size=(1, n, cfg.n_vitals)).astype(np.float32)
    return r.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32)


def _jpayload(cfg):
    return lambda sid, ev: jnp.asarray(_payload(cfg, sid, ev))


def _ppayload(cfg):
    return lambda sid, ev: _payload(cfg, sid, ev)


def _jagg(old, new):
    if old is not None and new.ndim == 3:
        return jnp.concatenate([old, new], axis=1)
    return new


def _pagg(old, new):
    if old is not None and new.dim() == 3:
        return torch.cat([old, new], dim=1)
    return new


def _lag_episodes(pkg, n_per_scenario=1):
    return {f"s{i}{j}": pkg.async_episode(name, seed=i * 7 + j, n_vitals=2,
                                          n_scene=2)
            for i, name in enumerate(sorted(pkg.LAG_SCENARIOS))
            for j in range(n_per_scenario)}


def _close(got, want, atol=ATOL, ctx=""):
    assert sorted(got) == sorted(want), ctx
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=atol, rtol=0, err_msg=f"{ctx}[{k}]")


def _pred_key(p):
    return (p.sid, p.step, p.model, tuple(p.modalities), p.kind, p.flush_id)


def _same_flushes(jeng, peng, atol=ATOL):
    """Flush for flush: counts exact, predictions in the same order with
    the same keys, outputs within ``atol``."""
    assert jeng.flushes_total == peng.flushes_total > 0
    assert len(jeng.flushes) == len(peng.flushes)
    n_preds = 0
    for a, b in zip(jeng.flushes, peng.flushes):
        assert (a.flush_id, a.n_events, a.n_encoder_calls, a.n_tail_calls) \
            == (b.flush_id, b.n_events, b.n_encoder_calls, b.n_tail_calls)
        assert sorted(a.latencies) == sorted(b.latencies)
        assert b.flops_useful == pytest.approx(a.flops_useful, rel=1e-12)
        assert b.flops_padded == pytest.approx(a.flops_padded, rel=1e-12)
        assert [_pred_key(p) for p in a.predictions] == \
            [_pred_key(p) for p in b.predictions]
        for pa, pb in zip(a.predictions, b.predictions):
            _close(pb.outputs, pa.outputs, atol, ctx=str(_pred_key(pa)))
        assert sorted(a.recommendations) == sorted(b.recommendations)
        n_preds += len(a.predictions)
    assert jeng.encoder_calls_total() == peng.encoder_calls_total()
    assert jeng.tail_calls_total() == peng.tail_calls_total()
    return n_preds


# ======================================================================
# Layouts: stack_bucketed and RaggedBatch.pack, exactly the reference's
# ======================================================================

@pytest.mark.parametrize("modality", ["text", "vitals", "scene"])
def test_stack_bucketed_matches_reference(modality):
    """Bucketed rows (crops, pads, a masked-vitals dict) stacked with
    surplus rows: the same arrays as the reference's."""
    rng = np.random.default_rng(1)
    shapes = {"text": [(1, 3), (1, 9), (1, 20)],
              "vitals": [(1, 2, 6), (1, 7, 6), (1, 12, 6)],
              "scene": [(1, 3)] * 3}[modality]
    rows = [(rng.integers(1, 99, s).astype(np.int32) if modality == "text"
             else rng.normal(size=s).astype(np.float32)) for s in shapes]
    jb, pb = JB.Bucketer(max_buckets={modality: 8}), \
        PB.Bucketer(max_buckets={modality: 8})
    jrows = [jb.fit(modality, jnp.asarray(r)) for r in rows]
    prows = [pb.fit(modality, torch.from_numpy(r)) for r in rows]
    by_shape = {}
    for jr, pr in zip(jrows, prows):
        lead = jr["x"] if isinstance(jr, dict) else jr
        by_shape.setdefault(tuple(lead.shape), []).append((jr, pr))
    for group in by_shape.values():
        want = JB.stack_bucketed([g[0] for g in group], 8)
        got = PB.stack_bucketed([g[1] for g in group], 8)
        want = want if isinstance(want, dict) else {"x": want}
        got = got if isinstance(got, dict) else {"x": got}
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
            assert got[k].shape[0] == 8
    assert pb.histogram == jb.histogram


@pytest.mark.parametrize("modality", ["text", "vitals"])
def test_ragged_pack_matches_reference(modality):
    """Empty rows, rows at and over the cap, interior PAD tokens, rows
    that leave gaps: every key of the pack and the shape histogram equal
    the reference's."""
    rng = np.random.default_rng(2)
    lens = [0, 16, 1, 5, 20, 9] if modality == "text" else [3, 0, 8, 12, 1]
    if modality == "text":
        rows = [rng.integers(0, 99, (1, n)).astype(np.int32) for n in lens]
        caps = {"text": 16}
    else:
        rows = [rng.normal(size=(1, n, 2)).astype(np.float32) for n in lens]
        caps = {"vitals": 8}
    jr = JB.RaggedBatch(max_lengths=caps, min_rows=2)
    pr = PB.RaggedBatch(max_lengths=caps, min_rows=2)
    for _ in range(2):
        want = jr.pack(modality, [jnp.asarray(r) for r in rows])
        got = pr.pack(modality, rows)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == {np.int32: torch.int32,
                                    np.float32: torch.float32,
                                    np.bool_: torch.bool}[
                np.asarray(want[k]).dtype.type], k
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert pr.histogram == jr.histogram and pr.n_shapes() == 1


def test_ragged_pack_text_layout():
    """Offsets start on align boundaries, rows sit where their offsets say
    (a crop keeps the head), surplus rows are (offset=total, length=0),
    and T and R are powers of two."""
    rb = PB.RaggedBatch(align=8, max_lengths={"text": 16})
    rng = np.random.default_rng(0)
    lens = [0, 16, 1, 5, 20]
    rows = [rng.integers(1, 99, (1, n)).astype(np.int32) for n in lens]
    p = rb.pack("text", rows)
    offsets, lengths = p["offsets"].numpy(), p["lengths"].numpy()
    toks, seg = p["tokens"].numpy(), p["row_ids"].numpy()
    T = toks.shape[1]
    assert T & (T - 1) == 0 and len(offsets) & (len(offsets) - 1) == 0
    for i, (r, n) in enumerate(zip(rows, lens)):
        keep = min(n, 16)
        assert lengths[i] == keep and offsets[i] % 8 == 0
        assert np.array_equal(toks[0, offsets[i]:offsets[i] + keep],
                              r[0, :keep])
        assert np.all(seg[offsets[i]:offsets[i] + keep] == i)
    total = max(int(o + -(-n // 8) * 8) for o, n in zip(offsets, lengths))
    for i in range(len(rows), len(offsets)):
        assert lengths[i] == 0 and offsets[i] == total <= T
    assert int((seg >= 0).sum()) == int(lengths.sum())


def test_ragged_pack_vitals_layout_and_refusal():
    """Vitals pack back to back with a reset flag on each row's first
    step; a crop keeps the TAIL; fixed-size modalities have no layout."""
    rb = PB.RaggedBatch(max_lengths={"vitals": 8})
    rng = np.random.default_rng(1)
    lens = [3, 0, 8, 12, 1]
    rows = [rng.standard_normal((1, n, 2)).astype(np.float32) for n in lens]
    p = rb.pack("vitals", rows)
    x, reset = p["x"].numpy(), p["reset"].numpy()
    o = 0
    for r, n in zip(rows, lens):
        keep = min(n, 8)
        assert np.array_equal(x[0, o:o + keep], r[0, n - keep:])
        if keep:
            assert reset[o, 0, 0] and not reset[o + 1:o + keep, 0, 0].any()
        o += keep
    with pytest.raises(ValueError, match="no ragged layout"):
        rb.pack("scene", [np.zeros((1, 3), np.float32)])


def test_stack_bucketed_raises_on_key_mismatch():
    a = {"x": torch.zeros((1, 4)), "mask": torch.ones((1, 4))}
    with pytest.raises(ValueError, match="key"):
        PB.stack_bucketed([a, {"x": torch.zeros((1, 4))}], 2)
    out = PB.stack_bucketed([a, {"x": torch.ones((1, 4)),
                                 "mask": torch.zeros((1, 4))}], 4)
    assert out["x"].shape == (4, 4) and out["mask"].shape == (4, 4)


def test_to_device_keeps_cpu_tensors():
    """Staging on the CPU hands the same tensors back (no copy); the
    card path copies once per key (exercised by chip_smoke.py)."""
    x = {"a": torch.ones(3), "b": torch.zeros(2)}
    out = PB.to_device(x, "cpu")
    assert out["a"] is x["a"] and out["b"] is x["b"]


# ======================================================================
# Ragged encoders: each packed row == the reference's natural row
# ======================================================================

def _params(jcfg, seed=0):
    # one compiled initialiser: op-by-op initialisation compiles every op
    jp = jax.jit(lambda k: JE.init_params(jcfg, k))(jax.random.PRNGKey(seed))
    return jp, from_jax_numpy(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("flash", [True, False])
def test_ragged_text_encoder_matches_reference_rows(flash):
    """One packed call of the port's text encoder (segment-masked flash,
    or the pair-masked einsum) == the reference's natural per-row
    encoder on every row (1e-5), with empty rows, a crop, an interior
    PAD token and surplus rows. The reference row runs its einsum path,
    whose key mask takes any PAD layout (its flash path assumes PAD
    suffixes)."""
    jcfg, cfg = _cfgs(use_flash_text=False)
    cfg = tiny(text_encoder=TEXT, use_flash_text=flash)
    jp, pp = _params(jcfg)
    rng = np.random.default_rng(4)
    lens = [5, 0, 16, 3, 20, 1]
    rows = [rng.integers(1, cfg.vocab_size, (1, n)).astype(np.int32)
            for n in lens]
    rows[3][0, 1] = 0                                 # an interior PAD
    packed = PB.RaggedBatch(max_lengths={"text": cfg.max_text_len},
                            min_rows=8).pack("text", rows)
    got = PE.text_encoder(pp["text"], cfg, packed)
    assert got.shape == (8, cfg.feature_dims["text"])
    # the reference's rows in one padded batch: its key mask makes each
    # row the natural one (an all-PAD row pools to zeros)
    padded = np.zeros((len(rows), cfg.max_text_len), np.int32)
    for i, r in enumerate(rows):
        r = r[0, :cfg.max_text_len]
        padded[i, :len(r)] = r
    want = np.asarray(jax.jit(lambda p, x: JE.text_encoder(p, jcfg, x))(
        jp["text"], jnp.asarray(padded)))
    for i in range(len(rows)):
        np.testing.assert_allclose(got[i:i + 1].numpy(), want[i:i + 1],
                                   atol=ATOL, rtol=0, err_msg=f"row {i}")
    assert float(got[len(rows):].abs().max()) == 0.0   # surplus rows


@pytest.mark.parametrize("kind", ["rnn", "gru", "lstm"])
def test_ragged_vitals_encoder_matches_reference_rows(kind):
    """The ragged scan (reset at each row's first step, the state
    gathered at its last) == the reference's natural per-row scan."""
    jcfg, cfg = _cfgs(vitals_encoder=kind)
    jp, pp = _params(jcfg)
    rng = np.random.default_rng(5)
    lens = [4, 0, 8, 1, 12]
    rows = [rng.normal(size=(1, n, cfg.n_vitals)).astype(np.float32)
            for n in lens]
    packed = PB.RaggedBatch(max_lengths={"vitals": 8}).pack("vitals", rows)
    got = PE.vitals_encoder(pp["vitals"], cfg, packed)
    # the reference's rows as one length-masked batch (each row's tail
    # kept, as the crop keeps it): its natural per-row states
    x = np.zeros((len(rows), 8, cfg.n_vitals), np.float32)
    for i, r in enumerate(rows):
        r = r[0, -8:]
        x[i, :len(r)] = r
    want = np.asarray(JE.vitals_encoder(jp["vitals"], jcfg, {
        "x": jnp.asarray(x),
        "len": jnp.asarray([min(n, 8) for n in lens], jnp.int32)}))
    for i in range(len(rows)):
        np.testing.assert_allclose(got[i:i + 1].numpy(), want[i:i + 1],
                                   atol=ATOL, rtol=0,
                                   err_msg=f"{kind} row {i}")


def test_ragged_encoders_match_reference_ragged_forms():
    """The same packed payload through both packages' ragged forms (the
    port's segment-masked flash against the reference's pair-masked
    einsum)."""
    jcfg, cfg = _cfgs(use_flash_text=False)
    cfg = tiny(text_encoder=TEXT, use_flash_text=True)
    jp, pp = _params(jcfg, seed=1)
    rng = np.random.default_rng(6)
    text = [rng.integers(1, cfg.vocab_size, (1, n)).astype(np.int32)
            for n in (7, 2, 13)]
    vit = [rng.normal(size=(1, n, cfg.n_vitals)).astype(np.float32)
           for n in (3, 6, 1)]
    for m, rows, enc, jenc in (("text", text, PE.text_encoder,
                                JE.text_encoder),
                               ("vitals", vit, PE.vitals_encoder,
                                JE.vitals_encoder)):
        got = enc(pp[m], cfg, PB.RaggedBatch().pack(m, rows))
        want = jax.jit(lambda p, x, f=jenc: f(p, jcfg, x))(
            jp[m], JB.RaggedBatch().pack(m, [jnp.asarray(r) for r in rows]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_segment_flash_packed_equals_per_row():
    """Rows packed at 8-aligned offsets through ONE segment-masked call
    of the flash wrapper == each row alone (its plain version here)."""
    rng = np.random.default_rng(7)
    H, D = 4, 16
    lens = [5, 8, 13, 1]
    rows = [torch.from_numpy(rng.normal(size=(1, n, 3, H, D))
                             .astype(np.float32)) for n in lens]
    offs, o = [], 0
    for n in lens:
        offs.append(o)
        o += -(-n // 8) * 8
    qkv = torch.zeros((1, o, 3, H, D))
    seg = torch.full((1, o), -1, dtype=torch.int32)
    for i, (r, off, n) in enumerate(zip(rows, offs, lens)):
        qkv[:, off:off + n] = r
        seg[0, off:off + n] = i
    out = ops.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              causal=False, segment_ids=seg, block_q=8,
                              block_k=8)
    for r, off, n in zip(rows, offs, lens):
        alone = ops.flash_attention(r[:, :, 0], r[:, :, 1], r[:, :, 2],
                                    causal=False,
                                    kv_lengths=torch.tensor([n]))
        np.testing.assert_allclose(out[:, off:off + n].numpy(),
                                   alone.numpy(), atol=ATOL, rtol=0)
    assert float(out[seg < 0].abs().max()) == 0.0


def test_grouped_tail_equals_subset_tails():
    """For every modality subset, the FULL heads over features with zeros
    in the missing slices == the subset-sliced heads (1e-5)."""
    jcfg, cfg = _cfgs()
    _, pp = _params(jcfg)
    dims = cfg.feature_dims
    g = torch.Generator().manual_seed(5)
    feats = {m: torch.randn((4, dims[m]), generator=g) for m in ALL}
    for r in range(1, 4):
        for subset in combinations(ALL, r):
            ph = PE.slice_heads(pp["heads"], cfg, ALL, subset)
            want = PE.fuse_and_heads(ph, feats, subset)
            filled = {m: feats[m] if m in subset
                      else torch.zeros((4, dims[m])) for m in ALL}
            got = PE.fuse_and_heads(pp["heads"], filled, ALL)
            _close(got, want, ctx=str(subset))


# ======================================================================
# Engines against the reference, flush for flush
# ======================================================================

def _both(models, spec, jkw=None, pkw=None, **kw):
    (jsplits, jparams), (psplits, pparams) = models
    jeng = JA.build_engine(jsplits, jparams, spec, **{**kw, **(jkw or {})})
    peng = PA.build_engine(psplits, pparams, spec, device="cpu",
                           **{**kw, **(pkw or {})})
    return jeng, peng


def test_batch_engine_matches_reference_per_arrival(indep):
    """'batch' over the LAG_SCENARIOS interleaving, a flush after every
    arrival, vitals growing by aggregation: every flush's counts and
    every recommendation agree."""
    cfg, jm, pm = indep
    jeng, peng = _both((jm, pm), "batch",
                       jkw={"bucketer": JB.Bucketer(max_buckets={"vitals": 8,
                                                                 "text": 16})},
                       pkw={"bucketer": PB.Bucketer(max_buckets={"vitals": 8,
                                                                 "text": 16})})
    for eng, pkg, pay, agg in ((jeng, J, _jpayload(cfg), _jagg),
                               (peng, P, _ppayload(cfg), _pagg)):
        for _t, sid, ev in pkg.merge_arrivals(_lag_episodes(pkg)):
            eng.submit(sid, ev, pay(sid, ev), aggregate=agg)
            eng.flush()
    assert _same_flushes(jeng, peng) > 0
    assert peng.bucketer.histogram == jeng.bucketer.histogram
    for sid in jeng.sessions:
        _close(peng.sessions[sid].last_recommendation,
               jeng.sessions[sid].last_recommendation)


def test_batch_run_episodes_matches_reference(indep):
    """Tick-driven 'batch' (Table-6 episodes, 3 sessions, a batch bucket
    floor of 4, the auto bucket grid): the same flushes and rows."""
    cfg, jm, pm = indep
    jeng, peng = _both((jm, pm), "batch", batch_bucket_min=4,
                       max_history=None)
    for eng, pkg, pay in ((jeng, J, _jpayload(cfg)),
                          (peng, P, _ppayload(cfg))):
        eps = {f"s{i}": pkg.table6()[1 + i % 3] for i in range(3)}
        eng.run_episodes(eps, pay)
    assert _same_flushes(jeng, peng) > 0
    assert peng.bucketer.histogram == jeng.bucketer.histogram


def test_ragged_grouped_engine_matches_reference(zoo):
    """'batch+stream' with ragged=True: one packed call per modality and
    ONE grouped tail per flush, coalesced over 3 s of episode time, two
    sessions per lag scenario — flush for flush, prediction for
    prediction, with the same packed-shape histogram."""
    cfg, jm, pm, _, _ = zoo
    jeng, peng = _both((jm, pm), "batch+stream", share_encoders=True,
                       ragged=True, deadline_s=None, batch_bucket_min=2,
                       max_history=None)
    jeng.run_arrivals(_lag_episodes(J, 2), _jpayload(cfg), sim_window=3.0)
    peng.run_arrivals(_lag_episodes(P, 2), _ppayload(cfg), sim_window=3.0)
    assert _same_flushes(jeng, peng) > 0
    assert all(f.n_tail_calls <= 1 for f in peng.flushes)
    assert peng.ragged.histogram == jeng.ragged.histogram
    assert any(f.n_encoder_calls >= 2 for f in peng.flushes)


def test_ragged_engine_with_per_model_params_keeps_model_tails(indep):
    """Ragged encodes over independently parameterised models: no shared
    dict, so the per-model tail loop runs, as in the reference."""
    cfg, jm, pm = indep
    jeng, peng = _both((jm, pm), "batch", ragged=True, max_history=None)
    for eng, pkg, pay in ((jeng, J, _jpayload(cfg)),
                          (peng, P, _ppayload(cfg))):
        eps = {f"s{i}": pkg.table6()[1 + i] for i in range(2)}
        eng.run_episodes(eps, pay)
    assert _same_flushes(jeng, peng) > 0
    assert any(f.n_tail_calls > 1 for f in peng.flushes)


# ======================================================================
# The port's own invariants
# ======================================================================

def _port_engine(zoo, *, ragged, sim_window, n_per_scenario=2):
    cfg, _, (psplits, pparams), _, _ = zoo
    eng = PA.build_engine(psplits, pparams, "batch+stream",
                          share_encoders=True, ragged=ragged,
                          deadline_s=None, batch_bucket_min=2,
                          max_history=None, device="cpu")
    eng.run_arrivals(_lag_episodes(P, n_per_scenario), _ppayload(cfg),
                     sim_window=sim_window)
    return eng


def test_ragged_equals_bucketed(zoo):
    """The packed layout and the grouped tail change no prediction: the
    ragged engine's predictions == the bucketed engine's, key for key,
    within 1e-5, with fewer calls and less padding."""
    ragged = _port_engine(zoo, ragged=True, sim_window=3.0)
    bucketed = _port_engine(zoo, ragged=False, sim_window=3.0)
    assert ragged.flushes_total == bucketed.flushes_total
    for a, b in zip(bucketed.flushes, ragged.flushes):
        assert [_pred_key(p) for p in a.predictions] == \
            [_pred_key(p) for p in b.predictions]
        for pa, pb in zip(a.predictions, b.predictions):
            _close(pb.outputs, pa.outputs, ctx=str(_pred_key(pa)))
    calls = [sum(f.n_encoder_calls + f.n_tail_calls for f in e.flushes)
             for e in (ragged, bucketed)]
    assert calls[0] < calls[1]
    assert np.mean([f.padded_flop_frac for f in ragged.flushes]) < \
        np.mean([f.padded_flop_frac for f in bucketed.flushes])


def test_ragged_coalescing_invariant(zoo):
    """Coalescing sessions into one packed flush changes no prediction:
    every (sid, step) both cadences emitted agrees within 1e-5, and the
    finals do; each coalesced flush issues at most one call per modality
    and one grouped tail, and the packed shapes stay bounded."""
    per_event = _port_engine(zoo, ragged=True, sim_window=0.0)
    coalesced = _port_engine(zoo, ragged=True, sim_window=3.0)
    assert coalesced.flushes_total < per_event.flushes_total
    for f in coalesced.flushes:
        assert f.n_encoder_calls <= len(ALL) and f.n_tail_calls <= 1
    a = {(p.sid, p.step): p for s in per_event.sessions.values()
         for p in s.predictions}
    b = {(p.sid, p.step): p for s in coalesced.sessions.values()
         for p in s.predictions}
    for sid in coalesced.sessions:
        pa = per_event.sessions[sid].predictions[-1]
        pb = coalesced.sessions[sid].predictions[-1]
        assert pa.kind == pb.kind == "final"
        _close(pb.outputs, pa.outputs, ctx=sid)
    common = set(a) & set(b)
    assert common
    for key in common:
        _close(b[key].outputs, a[key].outputs, ctx=str(key))
    assert coalesced.ragged.n_shapes() <= 8


def test_ragged_engine_matches_per_event_engine(zoo):
    """Ragged serving at the per-event cadence == the port's per-event
    ``EMSServe`` (natural shapes, no bucketing) on every lag scenario,
    with ONE packed encoder call and ONE grouped tail per flush."""
    cfg, _, (psplits, pparams), _, _ = zoo
    eps = _lag_episodes(P)
    refs = {sid: P.EMSServe(psplits, pparams, cached=True, real_time=True,
                            session=sid, device="cpu") for sid in eps}
    eng = PA.build_engine(psplits, pparams, "batch+stream",
                          share_encoders=True, ragged=True, deadline_s=0.0,
                          max_history=None, device="cpu")
    checked = 0
    for _t, sid, ev in P.merge_arrivals(eps):
        x = _payload(cfg, sid, ev)
        if ev.modality == "text":
            x = x[:, :cfg.max_text_len]     # the per-event engine never crops
        rec = refs[sid].on_event(ev, x)
        rep = eng.submit(sid, ev, x)
        assert rep.n_encoder_calls <= 1 and rep.n_tail_calls <= 1
        if rec.recommendation is None:
            assert not rep.predictions
            continue
        (pred,) = rep.predictions
        _close(pred.outputs, rec.recommendation, ctx=f"{sid}@{ev.index}")
        checked += 1
    assert checked > len(eps)


def test_engine_ragged_off_is_inert(zoo):
    cfg, _, (psplits, pparams), _, _ = zoo
    eng = PA.build_engine(psplits, pparams, "batch+stream",
                          share_encoders=True, deadline_s=0.0, device="cpu")
    assert eng.ragged is None and eng.bucketer is not None
    ev = P.Event(index=0, modality="scene", arrival_time=0.0)
    rep = eng.submit("s0", ev, _payload(cfg, "s0", ev))
    assert rep is not None and rep.n_events == 1


def test_flush_keeps_inputs_on_the_host(zoo):
    """Flush-mode intake keeps each session's inputs on the host (a flush
    stages stacked batches with one copy per key); features and outputs
    come from the engine's device."""
    cfg, _, (psplits, pparams), _, _ = zoo
    eng = PA.build_engine(psplits, pparams, "batch", share_encoders=True,
                          device="cpu")
    ev = P.Event(0, "text", 0.0)
    eng.submit("s0", ev, _payload(cfg, "s0", ev))
    assert eng.sessions["s0"].inputs["text"].device.type == "cpu"
    rep = eng.flush()
    assert rep.n_encoder_calls == 1 and rep.predictions[0].model == "text"


# ======================================================================
# Flush accounting, shims and shape bounds
# ======================================================================

@pytest.fixture(scope="module")
def one_model():
    jcfg, cfg = _cfgs()
    jmod = J.emsnet_module(jcfg, ("scene",))
    jparams = {"m": jax.jit(jmod.init_fn)(jax.random.PRNGKey(0))}
    splits = {"m": P.split(P.emsnet_module(cfg, ("scene",)))}
    params = {"m": from_jax_numpy(jax.device_get(jparams["m"]), "cpu")}
    return cfg, splits, params


def test_flush_latency_dedupes_duplicate_submission(one_model):
    """A duplicate (sid, idx) submission counts once, with the EARLIEST
    submit time."""
    cfg, splits, params = one_model
    clock = [10.0]
    eng = PA.build_engine(splits, params, "batch", time_fn=lambda: clock[0],
                          device="cpu")
    ev = P.Event(index=0, modality="scene", arrival_time=0.0)
    x = np.zeros((1, cfg.scene_dim), np.float32)
    eng.submit("s0", ev, x)
    clock[0] = 11.0
    eng.submit("s0", ev, x)
    clock[0] = 12.0
    rep = eng.flush()
    assert rep.n_events == 1 and set(rep.latencies) == {("s0", 0)}
    assert rep.latencies[("s0", 0)] == pytest.approx(2.0)
    assert rep.wall_s == 0.0


def test_bucketer_histogram_counts_served_groups_only(one_model):
    """A modality no model consumes never reaches the bucketer."""
    cfg, splits, params = one_model
    bk = PB.Bucketer(max_buckets={"vitals": 8})
    eng = PA.build_engine(splits, params, "batch", bucketer=bk, device="cpu")
    eng.submit("s0", P.Event(index=0, modality="vitals", arrival_time=0.0),
               np.zeros((1, 5, cfg.n_vitals), np.float32))
    rep = eng.flush()
    assert rep.n_encoder_calls == 0 and bk.histogram == {}


def test_batched_flush_coalesces_calls(indep):
    """ONE encoder call per (modality, bucket) per consuming model, not
    one per session."""
    cfg, _, (psplits, pparams) = indep
    eng = BatchedEMSServe(psplits, pparams, device="cpu",
                          bucketer=PB.Bucketer(max_buckets={"vitals": 8}))
    x = np.ones((1, 3, cfg.n_vitals), np.float32)
    for i in range(6):
        eng.submit(f"s{i}", P.Event(0, "vitals", 0.0), x)
    rep = eng.flush()
    assert (rep.n_events, rep.n_encoder_calls, rep.n_tail_calls) == (6, 2, 0)


def test_legacy_batched_shim_equals_spec_engine(indep):
    """BatchedEMSServe == build_engine('batch') within the port, at
    atol 0: same cadence, counts and recommendations."""
    cfg, _, (psplits, pparams) = indep
    eps = _lag_episodes(P)

    def drive(eng):
        for _t, sid, ev in P.merge_arrivals(eps):
            eng.submit(sid, ev, _payload(cfg, sid, ev), aggregate=_pagg)
            eng.flush()
        return eng.flushes

    mk = lambda: PB.Bucketer(max_buckets={"vitals": 8})  # noqa: E731
    legacy = drive(BatchedEMSServe(psplits, pparams, bucketer=mk(),
                                   device="cpu"))
    unified = drive(PA.build_engine(psplits, pparams, "batch", bucketer=mk(),
                                    max_history=None, device="cpu"))
    assert len(legacy) == len(unified) > 0
    for a, b in zip(legacy, unified):
        assert (a.n_events, a.n_encoder_calls, a.n_tail_calls) == \
            (b.n_events, b.n_encoder_calls, b.n_tail_calls)
        assert sorted(a.recommendations) == sorted(b.recommendations)
        for sid in a.recommendations:
            _close(b.recommendations[sid], a.recommendations[sid], atol=0)


def test_shape_histograms_plateau_with_growing_vitals(indep):
    """What bounds the per-shape capture is the set of shapes served: a
    vitals series growing to 40 steps over 40 flushes is served at O(log)
    bucketed shapes, and the packed layout at O(log^2) (rows, length)
    shapes. ``compile_count()`` is the number of distinct signatures
    served: one per live shape for each of the two vitals encoders, and
    flat once the last bucket (64) is reached at step 33."""
    cfg, _, (psplits, pparams) = indep
    for ragged in (False, True):
        splits = {k: P.split(sm.module) for k, sm in psplits.items()}
        eng = PA.build_engine(splits, pparams, "batch", ragged=ragged,
                              bucketer=PB.Bucketer(), device="cpu")
        x = np.ones((1, 1, cfg.n_vitals), np.float32)
        counts = []
        for i in range(40):
            eng.submit("s0", P.Event(i, "vitals", float(i)), x,
                       aggregate=_pagg)
            eng.submit("s1", P.Event(i, "vitals", float(i)), x,
                       aggregate=_pagg)
            eng.flush()
            counts.append(eng.compile_count())
        shapes = (eng.ragged.n_shapes() if ragged
                  else eng.bucketer.n_buckets())
        assert shapes <= 5, (ragged, shapes)     # 8, 16, 32, 64 (+ R)
        assert eng.compile_count() == 2 * shapes  # m2's and m3's encoders
        assert counts[32:] == [counts[32]] * 8
        assert eng.sessions["s0"].inputs["vitals"].shape[1] == 40


def test_flash_calls_are_layers_times_text_encodes(zoo):
    """The count the card run is held to: every text encoder call of a
    flush makes one flash call per layer, bucketed and packed alike, and
    a CPU run launches nothing."""
    from repro_torch.kernels import flash_attention as FA
    cfg, _, (psplits, pparams), _, _ = zoo
    for ragged in (False, True):
        calls = [0]
        splits = {k: P.split(sm.module) for k, sm in psplits.items()}
        for sm in splits.values():
            if "text" in sm.encoders:
                def enc(p, x, f=sm.encoders["text"]):
                    calls[0] += 1
                    return f(p, x)
                sm.encoders["text"] = enc
        eng = PA.build_engine(splits, pparams, "batch+stream",
                              share_encoders=True, ragged=ragged,
                              deadline_s=None, device="cpu")
        FA.flash_attention.calls = FA.flash_attention.launches = 0
        eng.run_arrivals(_lag_episodes(P), _ppayload(cfg), sim_window=3.0)
        assert calls[0] > 0
        assert FA.flash_attention.calls == cfg.text_dims[0] * calls[0]
        assert FA.flash_attention.launches == 0


def test_batched_sessions_match_per_event_engine(indep):
    """N coalesced sessions, each flushed once per tick, give each session
    the same recommendations as its own per-event ``EMSServe`` with the
    same bucket grid (1e-5), vitals growing by aggregation."""
    cfg, _, (psplits, pparams) = indep
    eps = {f"s{i}": P.table6()[1 + i % 3] for i in range(3)}

    def pay(sid, ev):
        x = _payload(cfg, sid, ev)
        return x[:, :cfg.max_text_len] if ev.modality == "text" else x

    mk = lambda: PB.Bucketer(max_buckets={"vitals": 8})  # noqa: E731
    beng = BatchedEMSServe(psplits, pparams, bucketer=mk(), device="cpu")
    got = {sid: [] for sid in eps}
    horizon = max(len(e) for e in eps.values())
    for t in range(horizon):
        for sid, evs in eps.items():
            beng.submit(sid, evs[t], pay(sid, evs[t]), aggregate=_pagg)
        rep = beng.flush()
        for sid, row in rep.recommendations.items():
            got[sid].append(row)
    for sid, events in eps.items():
        eng = P.EMSServe(psplits, pparams, cached=True, real_time=True,
                         bucketer=mk(), session=sid, device="cpu")
        eng.run_episode(events, lambda ev, sid=sid: pay(sid, ev),
                        aggregate=_pagg)
        want = [r.recommendation for r in eng.records
                if r.recommendation is not None]
        assert len(got[sid]) == len(want) > 0
        for a, b in zip(got[sid], want):
            _close(a, b, ctx=sid)
