"""The port's stream compositions (stream, batch+stream, stream+tiered),
spec parsing, deadlines, eviction, the wall-clock driver and the
launcher's flush-mode commands, on the CPU.

Engines run against the JAX reference with the same numpy payloads and
the JAX initialiser's weights converted through numpy. Tolerances:
float32 outputs 1e-5 (the reference's own for its engine parity,
``tests/test_unified_api.py``); outputs fused from an int8 feature 1e-4
(``tests/test_torch_tiered.py``'s ``INT8_ATOL``: a one-ulp scale
difference may flip one activation's rounding by a level); simulated
times 1e-9 (the port's in-order delivery is ``max(arrival, last)``, one
ulp from the reference's ``arrival + (last - arrival)``); flush, call
and prediction counts, kinds, models and steps exactly. The legacy shims
are held against the spec-built engines at atol 0 (one package, one
code path).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs.emsnet import tiny as jax_tiny
from repro.models import emsnet as JE
from repro.serving import api as JA
from repro.serving import event_loop as JL
from repro_torch import core as P
from repro_torch.configs.emsnet import tiny
from repro_torch.convert import from_jax_numpy
from repro_torch.core.feature_cache import StalenessError
from repro_torch.launch import serve as PL
from repro_torch.models import emsnet as PE
from repro_torch.serving import api as PA
from repro_torch.serving.event_loop import WallClockDriver
from repro_torch.serving.stream_engine import StreamingEMSServe

ATOL = 1e-5
INT8_ATOL = 1e-4
T_ATOL = 1e-9
TEXT = "microbert"
ALL = ("text", "vitals", "scene")
ORDERINGS = list(itertools.permutations(ALL))
TIERS = ("glass", "ph1", "edge64x")
INT8 = {"ph1": "int8", "edge64x": "int8"}
BASE = {"enc:text": 0.08, "enc:vitals": 0.01, "enc:scene": 0.05,
        "tail": 0.005, "full": 0.15}


@pytest.fixture(scope="module")
def zoo():
    jcfg, cfg = jax_tiny(text_encoder=TEXT), tiny(text_encoder=TEXT)
    jzoo = J.emsnet_zoo(jcfg)
    jsplits = {k: J.split(m) for k, m in jzoo.items()}
    jshared = jax.jit(jzoo["text+vitals+scene"].init_fn)(
        jax.random.PRNGKey(0))
    psplits = {k: P.split(m) for k, m in P.emsnet_zoo(cfg).items()}
    pshared = from_jax_numpy(jax.device_get(jshared), "cpu")
    rng = np.random.default_rng(0)
    payloads = {
        "text": rng.integers(1, cfg.vocab_size, (1, 11)).astype(np.int32),
        "vitals": rng.normal(size=(1, 5, cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }
    return (jcfg, cfg, (jsplits, {k: jshared for k in jsplits}),
            (psplits, {k: pshared for k in psplits}), jshared, pshared,
            payloads)


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


def _both(zoo, spec, **kw):
    _, _, (jsplits, jparams), (psplits, pparams), _, _, _ = zoo
    return (JA.build_engine(jsplits, jparams, spec, **kw),
            PA.build_engine(psplits, pparams, spec, device="cpu", **kw))


def _payload_fns(zoo):
    payloads = zoo[-1]
    return ({m: jnp.asarray(x) for m, x in payloads.items()}, payloads)


def _same_predictions(jeng, peng, atol=ATOL):
    """Every session's progressive prediction stream, in order."""
    assert list(jeng.sessions) == list(peng.sessions)
    n = 0
    for sid in jeng.sessions:
        a, b = jeng.sessions[sid].predictions, peng.sessions[sid].predictions
        assert [_pred_key(p) for p in a] == [_pred_key(p) for p in b], sid
        for pa, pb in zip(a, b):
            _close(pb.outputs, pa.outputs, atol, ctx=str(_pred_key(pa)))
        n += len(a)
    return n


# ======================================================================
# Spec parsing and the factory
# ======================================================================

def test_parse_spec_strings_and_aliases():
    es = PA.parse_spec("batch+stream")
    assert es.batch is not None and es.stream is not None
    assert es.placement is None and es.enabled() == ("batch", "stream")
    assert PA.parse_spec("batched+streaming").enabled() == ("batch",
                                                            "stream")
    es3 = PA.EngineSpec(stream=PA.StreamPolicy())
    assert PA.parse_spec(es3) is es3


def test_parse_spec_dict_sections_and_overrides():
    es = PA.parse_spec({"batch": {"max_coalesce": 32}, "stream": True,
                        "share_encoders": True},
                       deadline_s=0.25, batch_bucket_min=4)
    assert es.batch.max_coalesce == 32 and es.batch.batch_bucket_min == 4
    assert es.stream.deadline_s == 0.25 and es.share_encoders is True
    es2 = PA.parse_spec("stream", bucketer=None, batch_bucket_min=2)
    assert es2.batch is not None and es2.batch.batch_bucket_min == 2
    es3 = PA.parse_spec({"stream": {"deadline_s": 0.1}}, deadline_s=0.05)
    assert es3.stream.deadline_s == 0.05


@pytest.mark.parametrize("spec, kw, err", [
    ("batch+warp", {}, ValueError),
    ("", {}, ValueError),
    ("tiered", {}, ValueError),
    ("batch", {"deadline_s": 1.0}, ValueError),
    ({"stream": {"warp_factor": 9}}, {}, ValueError),
    (42, {}, TypeError),
])
def test_parse_spec_rejects_bad_input(spec, kw, err):
    with pytest.raises(err):
        PA.parse_spec(spec, **kw)


def test_build_engine_wires_policies(zoo):
    _, _, _, (psplits, pparams), _, _, payloads = zoo
    eng = PA.build_engine(psplits, pparams, "batch+stream", device="cpu",
                          share_encoders=True, deadline_s=None,
                          batch_bucket_min=2)
    assert isinstance(eng, PA.EMSServeEngine) and not eng.tiered
    assert eng.deadline_s is None and eng.batch_bucket_min == 2
    assert eng.bucketer is not None and eng.ragged is None
    tiered = PA.build_engine(psplits, pparams, "tiered", device="cpu",
                             share_encoders=True,
                             profile=P.ProfileTable(base=dict(BASE)),
                             trace=P.BandwidthTrace.static(
                                 P.nlos_bandwidth(0.0)))
    assert tiered.tiered and tiered.bucketer is None
    rec = tiered.ingest(PA.Arrival("s0", P.Event(0, "text", 0.0),
                                   payloads["text"]))
    assert rec.sid == "s0" and rec.outputs is not None
    assert rec.glass_partial is None        # no stream policy, no partials


def test_tiered_flush_mode_guards(zoo):
    with pytest.raises(ValueError, match="require tiered"):
        StreamingEMSServe({}, {}, device="cpu").run_arrivals(
            {}, lambda s, e: None, crash_at=1.0)


# ======================================================================
# Against the reference
# ======================================================================

def test_stream_engine_matches_reference(zoo):
    """'stream' flushed per arrival over the lag scenarios: prediction for
    prediction, flush for flush."""
    jeng, peng = _both(zoo, "stream", share_encoders=True, deadline_s=None,
                       max_history=None)
    jpay, ppay = _payload_fns(zoo)
    jeng.run_arrivals(_lag_episodes(J), lambda s, ev: jpay[ev.modality],
                      sim_window=0.0)
    peng.run_arrivals(_lag_episodes(P), lambda s, ev: ppay[ev.modality],
                      sim_window=0.0)
    assert jeng.flushes_total == peng.flushes_total > 0
    for a, b in zip(jeng.flushes, peng.flushes):
        assert (a.n_events, a.n_encoder_calls, a.n_tail_calls) == \
            (b.n_events, b.n_encoder_calls, b.n_tail_calls)
    assert _same_predictions(jeng, peng) > 0


def test_batch_stream_engine_matches_reference(zoo):
    """'batch+stream' coalesced over 2 s of episode time, vitals growing by
    aggregation: the same flushes, calls and predictions."""
    jeng, peng = _both(zoo, "batch+stream", share_encoders=True,
                       deadline_s=None, batch_bucket_min=2, max_history=None)
    jpay, ppay = _payload_fns(zoo)
    jeng.run_arrivals(
        _lag_episodes(J, 2), lambda s, ev: jpay[ev.modality], sim_window=2.0,
        aggregate=lambda o, n: n if o is None or n.ndim != 3
        else jnp.concatenate([o, n], axis=1))
    peng.run_arrivals(
        _lag_episodes(P, 2), lambda s, ev: ppay[ev.modality], sim_window=2.0,
        aggregate=lambda o, n: n if o is None or n.dim() != 3
        else torch.cat([o, n], dim=1))
    assert jeng.flushes_total == peng.flushes_total
    assert peng.flushes_total < sum(len(e) for e in _lag_episodes(P, 2)
                                    .values())
    for a, b in zip(jeng.flushes, peng.flushes):
        assert (a.n_events, a.n_encoder_calls, a.n_tail_calls) == \
            (b.n_events, b.n_encoder_calls, b.n_tail_calls)
        assert b.padded_flop_frac == pytest.approx(a.padded_flop_frac,
                                                   rel=1e-12)
    assert _same_predictions(jeng, peng) > 0
    assert peng.bucketer.histogram == jeng.bucketer.histogram


@pytest.mark.parametrize("precision", [None, INT8], ids=["fp32", "int8"])
def test_stream_tiered_matches_reference(zoo, precision):
    """'stream+tiered' on glass/ph1/edge64x over the lag scenarios, with
    and without int8 flights: every record's placement and timeline,
    every glass provisional partial (its model, step and t_emit on the
    glass clock it occupies) and the sessions' prediction streams."""
    _, _, (jsplits, jparams), (psplits, pparams), _, _, payloads = zoo

    def build(pkg, api, splits, params):
        kw = {"device": "cpu"} if api is PA else {}
        return api.build_engine(
            splits, params, "stream+tiered", share_encoders=True,
            max_history=None, tiers=TIERS, precision=precision,
            profile=pkg.ProfileTable(base=dict(BASE)),
            trace=pkg.BandwidthTrace.static(pkg.nlos_bandwidth(10.0)),
            tier_traces={"ph1": pkg.BandwidthTrace.static(
                pkg.nlos_bandwidth(0.0))}, **kw)

    jeng = build(J, JA, jsplits, jparams)
    peng = build(P, PA, psplits, pparams)
    jpay, ppay = _payload_fns(zoo)
    jeng.run_arrivals(_lag_episodes(J), lambda s, ev: jpay[ev.modality])
    peng.run_arrivals(_lag_episodes(P), lambda s, ev: ppay[ev.modality])
    assert len(jeng.records) == len(peng.records) > 0
    n_partials = 0
    for a, b in zip(jeng.records, peng.records):
        assert (a.sid, a.index, a.model, a.tier, a.enc_tier, a.tail_tier,
                a.precision, a.kind, a.fallback) == \
            (b.sid, b.index, b.model, b.tier, b.enc_tier, b.tail_tier,
             b.precision, b.kind, b.fallback)
        assert abs(a.t_emit - b.t_emit) <= T_ATOL
        assert abs(a.t_start - b.t_start) <= T_ATOL
        atol = INT8_ATOL if precision else ATOL
        if a.outputs is not None:
            _close(b.outputs, a.outputs, atol)
        assert (a.glass_partial is None) == (b.glass_partial is None)
        if a.glass_partial is not None:
            ga, gb = a.glass_partial, b.glass_partial
            assert _pred_key(ga) == _pred_key(gb)
            assert abs(ga.t_emit - gb.t_emit) <= T_ATOL
            _close(gb.outputs, ga.outputs, atol)
            n_partials += 1
    assert n_partials > 0
    assert _same_predictions(jeng, peng,
                             INT8_ATOL if precision else ATOL) > 0
    assert jeng.placement_counts() == peng.placement_counts()
    for sid in jeng.sessions:
        assert peng.time_to_first_prediction(sid) == pytest.approx(
            jeng.time_to_first_prediction(sid), abs=T_ATOL)


@pytest.mark.parametrize("order", ORDERINGS, ids=["-".join(o)
                                                  for o in ORDERINGS])
def test_every_arrival_order_matches_one_shot_forward(order, zoo):
    """For every modality arrival order: each intermediate prediction ==
    the reference's ``partial_forward`` on the arrived subset, the final
    == its one-shot ``forward``."""
    jcfg, _, _, (psplits, pparams), jshared, _, payloads = zoo
    eng = StreamingEMSServe(psplits, pparams, share_encoders=True,
                            device="cpu")
    jb = {m: jnp.asarray(x) for m, x in payloads.items()}
    for i, m in enumerate(order):
        rep = eng.submit("s0", P.Event(i, m, float(i)), payloads[m])
        (pred,) = rep.predictions
        arrived = tuple(mm for mm in ALL if mm in order[:i + 1])
        assert pred.modalities == arrived
        assert pred.kind == ("final" if i == 2 else "partial")
        _close(pred.outputs, JE.partial_forward(jshared, jcfg, jb, arrived))
    _close(pred.outputs, JE.forward(jshared, jcfg, jb))


# ======================================================================
# stream x tiered, in the port
# ======================================================================

def _stream_tiered(zoo, **kw):
    _, _, _, (psplits, pparams), _, _, _ = zoo
    kw.setdefault("trace", P.BandwidthTrace.static(P.nlos_bandwidth(10.0)))
    return PA.build_engine(psplits, pparams, "stream+tiered", device="cpu",
                           share_encoders=True,
                           profile=P.ProfileTable(base=dict(BASE)), **kw)


def test_stream_tiered_composition_glass_partials(zoo):
    """While an offloaded arrival is in flight the glasses emit a
    provisional partial from cached features (== ``partial_forward`` on
    the previously observed subset, landing before the refresh); the
    refreshed predictions are unchanged."""
    _, cfg, _, _, _, pshared, payloads = zoo
    eng = _stream_tiered(zoo)
    recs = [eng.submit("s0", P.Event(i, m, float(i)), payloads[m])
            for i, m in enumerate(ALL)]
    pb = {m: torch.from_numpy(x) for m, x in payloads.items()}
    assert [r.tier for r in recs] == ["edge", "edge", "edge"]
    assert recs[0].glass_partial is None
    for i in (1, 2):
        gp = recs[i].glass_partial
        assert gp is not None and gp.kind == "partial"
        assert gp.modalities == ALL[:i]
        _close(gp.outputs, PE.partial_forward(pshared, cfg, pb, ALL[:i]))
    assert recs[2].glass_partial.t_emit < recs[2].t_emit
    assert recs[-1].kind == "final"
    _close(recs[-1].outputs, PE.forward(pshared, cfg, pb))
    rec = eng.submit("s0", P.Event(3, "vitals", 4.0), payloads["vitals"])
    assert rec.glass_partial.modalities == ALL
    kinds = [p.kind for p in eng.sessions["s0"].predictions]
    assert kinds.count("partial") >= 3 and "final" in kinds
    assert eng.time_to_first_prediction("s0") is not None


def test_glass_partial_emitted_for_local_enc_remote_tail_split(zoo):
    """The encoder stays home and the tail goes to the phone: the split
    shape still serves an immediate glass partial."""
    _, cfg, _, _, _, pshared, payloads = zoo
    eng = _stream_tiered(
        zoo, trace=P.BandwidthTrace.static(P.nlos_bandwidth(0.0)),
        tiers=TIERS, force={"enc:text": "glass", "enc:vitals": "glass",
                            "enc:scene": "glass", "tail": "ph1"})
    recs = [eng.submit("s0", P.Event(i, m, float(i)), payloads[m])
            for i, m in enumerate(ALL)]
    pb = {m: torch.from_numpy(x) for m, x in payloads.items()}
    assert all(r.enc_tier == "glass" and r.tail_tier == "ph1" for r in recs)
    assert recs[0].glass_partial is None
    for i in (1, 2):
        gp = recs[i].glass_partial
        assert gp.modalities == ALL[:i] and gp.t_emit < recs[i].t_emit
        _close(gp.outputs, PE.partial_forward(pshared, cfg, pb, ALL[:i]))


def test_stream_tiered_staleness_invariant_still_asserted(zoo):
    payloads = zoo[-1]
    eng = _stream_tiered(
        zoo, trace=P.BandwidthTrace.static(P.nlos_bandwidth(0.0)))
    for i, m in enumerate(ALL):
        eng.submit("s0", P.Event(i, m, float(i)), payloads[m])
    eng.cache.peek("s0", "vitals").step -= 2
    with pytest.raises(StalenessError):
        eng.submit("s0", P.Event(3, "vitals", 4.0), payloads["vitals"])


def test_all_three_policies_compose(zoo):
    """batch+stream+tiered: the batch policy's bucketer bounds the tiered
    encoder shapes, glass partials flow, the final == ``forward``."""
    _, cfg, _, (psplits, pparams), _, pshared, payloads = zoo
    eng = PA.build_engine(
        psplits, pparams, "batch+stream+tiered", device="cpu",
        share_encoders=True,
        bucketer=P.Bucketer(max_buckets={"vitals": 8,
                                         "text": cfg.max_text_len}),
        profile=P.ProfileTable(base=dict(BASE)),
        trace=P.BandwidthTrace.static(P.nlos_bandwidth(0.0)))
    assert eng.tiered and eng.bucketer is not None
    for i, m in enumerate(ALL):
        rec = eng.submit("s0", P.Event(i, m, float(i)), payloads[m])
    assert rec.kind == "final" and eng.bucketer.n_buckets() >= 2
    _close(rec.outputs, PE.forward(
        pshared, cfg, {m: torch.from_numpy(x) for m, x in payloads.items()}))
    assert any(r.glass_partial is not None
               for r in eng.sessions["s0"].records)


def test_stream_tiered_eviction_runs_on_the_simulated_clock(zoo):
    payloads = zoo[-1]
    eng = _stream_tiered(
        zoo, max_sessions=1,
        trace=P.BandwidthTrace.static(P.nlos_bandwidth(0.0)))
    for i, m in enumerate(ALL):
        eng.submit("s0", P.Event(i, m, float(i)), payloads[m])
    assert ("s0", "text") in eng.cache
    eng.submit("s1", P.Event(0, "text", 10.0), payloads["text"])
    assert set(eng.sessions) == {"s1"} and eng.evicted_count == 1
    assert ("s0", "text") not in eng.cache
    assert not any(k[0] == "s0" for v in eng._replica_versions.values()
                   for k in v)


# ======================================================================
# Deadlines, history, eviction (a fake clock)
# ======================================================================

def _stream(zoo, **kw):
    _, cfg, _, (psplits, pparams), _, _, _ = zoo
    kw.setdefault("share_encoders", True)
    kw.setdefault("bucketer", P.Bucketer(max_buckets={
        "vitals": 8, "text": cfg.max_text_len}))
    return StreamingEMSServe(psplits, pparams, device="cpu", **kw)


def test_deadline_policy_buffers_then_flushes(zoo):
    payloads = zoo[-1]
    now = {"t": 0.0}
    eng = _stream(zoo, deadline_s=1.0, time_fn=lambda: now["t"])
    assert eng.submit("s0", P.Event(0, "text", 0.0), payloads["text"]) is None
    now["t"] = 0.5
    assert eng.poll() is None and eng.pending_count() == 1
    now["t"] = 1.5
    rep = eng.submit("s0", P.Event(1, "vitals", 1.5), payloads["vitals"])
    assert rep is not None and rep.n_events == 2
    assert rep.predictions[0].modalities == ("text", "vitals")
    assert rep.latencies == {("s0", 0): 1.5, ("s0", 1): 0.0}
    assert eng.poll() is None and eng.pending_count() == 0


def test_history_bounded_but_totals_keep_counting(zoo):
    payloads = zoo[-1]
    eng = _stream(zoo, max_history=2)
    for i in range(7):
        m = ALL[i % 3]
        eng.submit("s0", P.Event(i, m, float(i)), payloads[m])
    assert len(eng.flushes) == 2 and len(eng.sessions["s0"].predictions) == 2
    assert eng.flushes_total == 7 and eng.encoder_calls_total() == 7
    assert eng.flushes[-1].flush_id == 6
    assert eng.sessions["s0"].predictions[-1].kind == "final"


def test_refusion_never_reencodes_cached_modalities(zoo):
    payloads = zoo[-1]
    eng = _stream(zoo)
    for i, m in enumerate(ALL):
        eng.submit("s0", P.Event(i, m, float(i)), payloads[m])
    enc_before, hits_before = eng.encoder_calls_total(), eng.cache.hits
    for i in range(3, 8):
        rep = eng.submit("s0", P.Event(i, "vitals", float(i)),
                         payloads["vitals"])
        assert rep.n_encoder_calls == 1
        assert rep.predictions[0].kind == "final"
    assert eng.encoder_calls_total() == enc_before + 5
    assert eng.cache.hits >= hits_before + 10


def _eviction_runs(zoo, script):
    """Run one eviction script on both packages under the same fake
    clock; returns the two engines."""
    _, _, (jsplits, jparams), (psplits, pparams), _, _, payloads = zoo
    from repro.serving.stream_engine import StreamingEMSServe as JStream
    jpay = {m: jnp.asarray(x) for m, x in payloads.items()}
    out = []
    for pkg, cls, splits, params, pay, kw in (
            (J, JStream, jsplits, jparams, jpay, {}),
            (P, StreamingEMSServe, psplits, pparams, payloads,
             {"device": "cpu"})):
        now = {"t": 0.0}
        eng_kw = dict(script["engine"])
        eng = cls(splits, params, share_encoders=True,
                  time_fn=lambda now=now: now["t"], **eng_kw, **kw)
        for step in script["steps"]:
            now["t"] = step[0]
            if step[1] == "poll":
                eng.poll()
            elif step[1] == "flush":
                eng.flush()
            else:
                sid, idx, m = step[1:]
                eng.submit(sid, pkg.Event(idx, m, step[0]), pay[m])
        out.append(eng)
    return out


@pytest.mark.parametrize("script", [
    # idle timeout: a finalized incident and a partial one both go quiet
    {"engine": {"idle_timeout_s": 5.0},
     "steps": [(0.0, "s0", 0, "text"), (1.0, "s0", 1, "vitals"),
               (2.0, "s0", 2, "scene"), (3.0, "s1", 0, "text"),
               (3.0, "poll"), (8.5, "poll"), (9.0, "s0", 0, "vitals")]},
    # LRU over the cap: recency first, finalized only breaks ties
    {"engine": {"max_sessions": 2},
     "steps": [(0.0, "s0", 0, "text"), (1.0, "s0", 1, "vitals"),
               (2.0, "s0", 2, "scene"), (10.0, "s1", 0, "text"),
               (11.0, "s2", 0, "text"), (20.0, "s2", 1, "vitals"),
               (21.0, "s3", 0, "scene")]},
    # pending and dirty work is never evicted; the flush's sweep trims
    {"engine": {"max_sessions": 1, "deadline_s": None},
     "steps": [(0.0, "s0", 0, "text"), (0.0, "s1", 0, "vitals"),
               (0.0, "poll"), (1.0, "flush")]},
], ids=["idle", "lru", "pending"])
def test_eviction_matches_reference(zoo, script):
    jeng, peng = _eviction_runs(zoo, script)
    assert list(peng.sessions) == list(jeng.sessions)
    assert peng.evicted_count == jeng.evicted_count > 0
    assert sorted(k for k, _ in peng.cache.entries()) == \
        sorted(k for k, _ in jeng.cache._store.items())
    for sid in jeng.sessions:
        assert peng.sessions[sid].step == jeng.sessions[sid].step
    assert _same_predictions(jeng, peng) > 0


# ======================================================================
# The wall-clock driver and the legacy shim
# ======================================================================

class _FakeWall:
    def __init__(self):
        self.t = 0.0

    def clock(self):
        return self.t

    def sleep(self, s):
        self.t += max(s, 1e-4)


def test_wall_clock_driver_matches_reference(zoo):
    """The driver replays the lag scenarios at 10x on a fake monotonic
    clock and pumps deadline flushes: the same loop stats, flushes and
    predictions as the reference's driver on the same clock."""
    _, _, (jsplits, jparams), (psplits, pparams), _, _, payloads = zoo
    jpay = {m: jnp.asarray(x) for m, x in payloads.items()}
    runs = []
    for pkg, api, drv, splits, params, pay, kw in (
            (J, JA, JL.WallClockDriver, jsplits, jparams, jpay, {}),
            (P, PA, WallClockDriver, psplits, pparams, payloads,
             {"device": "cpu"})):
        fake = _FakeWall()
        eng = api.build_engine(splits, params, "batch+stream",
                               share_encoders=True, deadline_s=0.02,
                               batch_bucket_min=2, max_history=None,
                               time_fn=fake.clock, **kw)
        stats = drv(eng, speed=10.0, clock=fake.clock,
                    sleep_fn=fake.sleep).run(
            _lag_episodes(pkg), lambda s, ev, pay=pay: pay[ev.modality])
        runs.append((eng, stats))
    (jeng, js), (peng, ps) = runs
    assert (ps.arrivals, ps.polls, ps.flushes_fired) == \
        (js.arrivals, js.polls, js.flushes_fired)
    assert ps.wall_s == pytest.approx(js.wall_s, abs=1e-9)
    assert ps.flushes_fired > 0 and peng.pending_count() == 0
    assert jeng.flushes_total == peng.flushes_total
    assert _same_predictions(jeng, peng) > 0


def test_legacy_streaming_shim_equals_spec_engine(zoo):
    """StreamingEMSServe == build_engine('batch+stream') within the port,
    at atol 0."""
    _, _, _, (psplits, pparams), _, _, payloads = zoo

    def drive(eng):
        eng.run_arrivals(_lag_episodes(P), lambda s, ev: payloads[ev.modality],
                         sim_window=0.0)
        return [p for f in eng.flushes for p in f.predictions]

    legacy = drive(StreamingEMSServe(psplits, pparams, share_encoders=True,
                                     deadline_s=None, max_history=None,
                                     device="cpu"))
    unified = drive(PA.build_engine(psplits, pparams, "batch+stream",
                                    share_encoders=True, deadline_s=None,
                                    max_history=None, device="cpu"))
    assert len(legacy) == len(unified) > 0
    for a, b in zip(legacy, unified):
        assert _pred_key(a) == _pred_key(b)
        _close(b.outputs, a.outputs, atol=0)


# ======================================================================
# The launcher's flush-mode commands
# ======================================================================

def _serve(capsys, *argv):
    PL.main(["--device", "cpu", "--text-encoder", TEXT, *argv])
    return capsys.readouterr().out.strip().splitlines()


def test_launcher_batch_stream_ragged_on_cpu(capsys):
    out = _serve(capsys, "--engine", "batch+stream", "--sessions", "8",
                 "--ragged")
    assert any(ln.startswith("8 sessions, ") for ln in out)
    assert sum(ln.startswith("flush[") and " final " in ln
               for ln in out) >= 8
    assert out[-1].startswith("ragged flush: ") and out[-1].endswith("on cpu")


def test_launcher_batch_on_cpu(capsys):
    out = _serve(capsys, "--engine", "batch", "--sessions", "4")
    assert sum(ln.startswith("flush[") for ln in out) == 21
    assert out[-1].startswith("4 sessions, ") and out[-1].endswith("on cpu")


def test_launcher_stream_wall_clock_on_cpu(capsys):
    out = _serve(capsys, "--engine", "stream", "--sessions", "3",
                 "--wall-clock", "--deadline-ms", "50", "--speed", "40")
    assert sum(": time-to-first" in ln for ln in out) == 3
    assert out[-1].startswith("3 sessions, ") and out[-1].endswith("on cpu")


def test_launcher_stream_tiered_serves_glass_partials(capsys):
    out = _serve(capsys, "--engine", "stream+tiered", "--sessions", "2",
                 "--tiers", "glass,ph1,edge64x")
    assert any("(glass partial @" in ln for ln in out)
    assert out[-1].startswith("cumulative serving latency") and \
        out[-1].endswith("on cpu")


def test_launcher_flush_mode_needs_a_card_by_default():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.main(["--text-encoder", TEXT, "--engine", "batch+stream",
                 "--sessions", "2", "--ragged"])
