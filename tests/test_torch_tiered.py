"""The port's tiered EMSServeEngine against the JAX reference, on the CPU.

Both engines serve the 7-model subset zoo over ONE shared parameter dict
(the JAX initialiser's weights, converted through numpy) on the
three-tier surface glass / ph1 / edge64x, with ONE fixed
``ProfileTable`` written out here (two ``profile()`` runs would differ)
and the same numpy payloads. Placement runs on the simulated clock, so
records agree exactly in every placement field; times agree within 1e-9
(the port's in-order delivery is ``max(arrival, last)``, which the
reference computes as ``arrival + (last - arrival)``, one ulp apart at
worst). Outputs: float32 flights within 1e-5; int8 flights within
``INT8_ATOL`` (measured 2.4e-7 at seed 0; a one-ulp scale difference of
XLA's ``/ 127`` may flip one activation's rounding by one level).
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs.emsnet import tiny as jax_tiny
from repro.serving import api as JA
from repro.serving import transport as JT
from repro_torch import core as P
from repro_torch.configs.emsnet import tiny
from repro_torch.convert import from_jax_numpy
from repro_torch.launch import serve as PL
from repro_torch.models import quantized as PQ
from repro_torch.obs import Tracer
from repro_torch.serving import api as PA
from repro_torch.serving import transport as PT

TEXT = "microbert"
TIERS = ("glass", "ph1", "edge64x")
BASE = {"enc:text": 0.08, "enc:vitals": 0.01, "enc:scene": 0.05,
        "tail": 0.005, "full": 0.15}
INT8 = {"ph1": "int8", "edge64x": "int8"}
FP32_ATOL = 1e-5
INT8_ATOL = 1e-4
T_ATOL = 1e-9


@pytest.fixture(scope="module")
def zoos():
    jcfg, cfg = jax_tiny(text_encoder=TEXT), tiny(text_encoder=TEXT)
    jzoo = J.emsnet_zoo(jcfg)
    jsplits = {k: J.split(m) for k, m in jzoo.items()}
    jshared = jzoo["text+vitals+scene"].init_fn(jax.random.PRNGKey(0))
    psplits = {k: P.split(m) for k, m in P.emsnet_zoo(cfg).items()}
    pshared = from_jax_numpy(jax.device_get(jshared), "cpu")
    rng = np.random.default_rng(0)
    payloads = {
        "text": rng.integers(1, cfg.vocab_size, (1, 11)).astype(np.int32),
        "vitals": rng.normal(size=(1, 5, cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }
    return ((jsplits, {k: jshared for k in jzoo}),
            (psplits, {k: pshared for k in psplits}), payloads)


def _lag_episodes(pkg):
    return {f"s{i}": pkg.async_episode(name, seed=i * 7, n_vitals=2,
                                       n_scene=2)
            for i, name in enumerate(sorted(pkg.LAG_SCENARIOS))}


def _engine(pkg, api, splits, params, *, bandwidth=5.0, **kw):
    kw.setdefault("max_history", None)
    kw.setdefault("tier_traces",
                  {"ph1": pkg.BandwidthTrace.static(pkg.nlos_bandwidth(0.0))})
    kw.setdefault("trace", pkg.BandwidthTrace.static(
        pkg.nlos_bandwidth(bandwidth)))
    kw.setdefault("tiers", TIERS)
    if api is PA:
        kw["device"] = "cpu"
    return api.build_engine(splits, params, "tiered", share_encoders=True,
                            profile=pkg.ProfileTable(base=dict(BASE)), **kw)


def _run(zoos, pkg, *, crash_at=None, rejoin_at=None, **kw):
    (jsplits, jparams), (psplits, pparams), payloads = zoos
    api, splits, params = ((JA, jsplits, jparams) if pkg is J
                           else (PA, psplits, pparams))
    eng = _engine(pkg, api, splits, params, **kw)
    eng.run_arrivals(_lag_episodes(pkg), lambda sid, ev: payloads[ev.modality],
                     crash_at=crash_at, rejoin_at=rejoin_at)
    return eng


def _key(r):
    return (r.sid, r.index, r.model, r.tier, r.enc_tier, r.tail_tier,
            r.precision, r.kind, r.fallback)


def _same_runs(jeng, peng):
    assert len(jeng.records) == len(peng.records) > 0
    for a, b in zip(jeng.records, peng.records):
        assert _key(a) == _key(b)
        assert abs(a.t_start - b.t_start) <= T_ATOL
        assert abs(a.t_emit - b.t_emit) <= T_ATOL
        assert a.detect_s == pytest.approx(b.detect_s, abs=T_ATOL)
        assert (a.outputs is None) == (b.outputs is None)
        if a.outputs is not None:
            atol = INT8_ATOL if a.precision == "int8" else FP32_ATOL
            for k in a.outputs:
                np.testing.assert_allclose(b.outputs[k].numpy(),
                                           np.asarray(a.outputs[k]),
                                           atol=atol, rtol=0)
    jl, pl = jeng.fabric.stats(), peng.fabric.stats()
    assert list(jl) == list(pl)
    for link in jl:
        assert (jl[link]["bytes"], jl[link]["msgs"]) == \
            (pl[link]["bytes"], pl[link]["msgs"])
    assert jeng.placement_counts() == peng.placement_counts()
    assert jeng.tail_placement_counts() == peng.tail_placement_counts()
    assert jeng.total_latency_s() == pytest.approx(peng.total_latency_s(),
                                                   abs=1e-8)
    assert jeng.makespan_s() == pytest.approx(peng.makespan_s(), abs=T_ATOL)
    assert list(jeng.sessions) == list(peng.sessions)
    for sid in jeng.sessions:
        for stat in ("time_to_first_prediction", "time_to_final_prediction"):
            a, b = getattr(jeng, stat)(sid), getattr(peng, stat)(sid)
            assert (a is None) == (b is None)
            if a is not None:
                assert a == pytest.approx(b, abs=T_ATOL)
    ju, pu = jeng.transport_stats(), peng.transport_stats()
    assert (ju["uplink"]["bytes"], ju["downlink"]["bytes"]) == \
        (pu["uplink"]["bytes"], pu["downlink"]["bytes"])


@pytest.mark.parametrize("precision, bandwidth", [
    (None, 5.0), ({"ph1": "fp32", "edge64x": "fp32"}, 5.0), (INT8, 30.0),
    (INT8, 5.0)], ids=["off", "all_fp32", "int8_slow_edge", "int8"])
def test_engine_matches_reference_on_lag_scenarios(zoos, precision,
                                                   bandwidth):
    jeng = _run(zoos, J, precision=precision, bandwidth=bandwidth)
    peng = _run(zoos, P, precision=precision, bandwidth=bandwidth)
    _same_runs(jeng, peng)
    if precision == INT8:
        assert any(r.precision == "int8" for r in peng.records)


def test_engine_matches_reference_through_crash_and_rejoin(zoos):
    kw = dict(precision=INT8, bandwidth=5.0, crash_at=2.5, rejoin_at=6.0)
    jeng = _run(zoos, J, **kw)
    peng = _run(zoos, P, **kw)
    _same_runs(jeng, peng)
    assert peng.rejoin_count == jeng.rejoin_count == 1
    # detected at the first heartbeat after the crash; fresh after rejoin
    assert peng.metrics.get("fault.crashes_detected") == 1
    assert peng.detect_at is None and jeng.detect_at is None


def test_engine_matches_reference_on_a_failover(zoos):
    """A crash inside an edge64x flight: the record falls back to glass
    after the heartbeat stall, on both sides."""
    base = _run(zoos, P, precision=INT8, bandwidth=5.0)
    flight = next(r for r in base.records if r.enc_tier == "edge64x"
                  and r.t_emit - r.t_start > 1e-3)
    t = (flight.t_start + flight.t_emit) / 2
    jeng = _run(zoos, J, precision=INT8, bandwidth=5.0, crash_at=t)
    peng = _run(zoos, P, precision=INT8, bandwidth=5.0, crash_at=t)
    _same_runs(jeng, peng)
    assert peng.fallback_count >= 1
    assert any(r.fallback and r.detect_s > 0 for r in peng.records)


def test_legacy_two_tier_pair_matches_reference(zoos):
    (jsplits, jparams), (psplits, pparams), payloads = zoos
    engs = []
    for pkg, api, splits, params in ((J, JA, jsplits, jparams),
                                     (P, PA, psplits, pparams)):
        kw = {"device": "cpu"} if api is PA else {}
        eng = api.build_engine(
            splits, params, "tiered", share_encoders=False, max_history=None,
            profile=pkg.ProfileTable(base=dict(BASE)),
            trace=pkg.BandwidthTrace.static(pkg.nlos_bandwidth(10.0)), **kw)
        eng.run_arrivals(_lag_episodes(pkg),
                         lambda sid, ev: payloads[ev.modality], crash_at=4.2)
        engs.append(eng)
    _same_runs(*engs)
    assert engs[1].transport_stats()["uplink"]["name"] == "glass->edge"


# ------------------------------------------------- the port by itself

def test_all_fp32_map_is_bit_identical_to_no_map(zoos):
    plain = _run(zoos, P)
    mapped = _run(zoos, P, precision={"ph1": "fp32", "edge64x": "fp32"})
    assert len(plain.records) == len(mapped.records)
    for a, b in zip(plain.records, mapped.records):
        assert _key(a) == _key(b)
        assert (a.t_start, a.t_emit) == (b.t_start, b.t_emit)
        if a.outputs is not None:
            for k in a.outputs:
                assert torch.equal(a.outputs[k], b.outputs[k])
    assert mapped.policy.precisions is None
    assert plain.fabric.stats() == mapped.fabric.stats()


def test_int8_engine_packs_cache_and_derives_sidecar_once(zoos):
    eng = _run(zoos, P, precision=INT8, bandwidth=30.0)
    assert len(eng._qparams_cache) == 1
    packed = [e for _k, e in eng.cache.entries()
              if PQ.is_quantized_feature(e.feature)]
    assert packed
    assert all(e.feature["q"].dtype == torch.int8 for e in packed)
    finals = [r for r in eng.records if r.kind == "final"]
    assert finals and all(torch.isfinite(v).all() for r in finals
                          for v in r.outputs.values())


def test_bad_precision_maps_raise_the_reference_messages(zoos):
    (jsplits, jparams), (psplits, pparams), _ = zoos
    for prec in ({"mars": "int8"}, {"ph1": "int4"}):
        msgs = []
        for pkg, api, s, p in ((J, JA, jsplits, jparams),
                               (P, PA, psplits, pparams)):
            with pytest.raises(ValueError) as e:
                _engine(pkg, api, s, p, precision=prec)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert "unknown host or precision" in msgs[1]
    from dataclasses import replace
    bare = {k: P.split(replace(sm.module, quantize_fn=None))
            for k, sm in psplits.items()}
    with pytest.raises(ValueError, match="declares no quantize_fn"):
        _engine(P, PA, bare, pparams, precision={"ph1": "int8"})
    _engine(P, PA, bare, pparams, precision={"ph1": "fp32"})


def test_later_slices_raise_not_implemented(zoos):
    (_, _), (psplits, pparams), _ = zoos
    for spec in ("batch", "stream+tiered", {"stream": True}):
        with pytest.raises(NotImplementedError, match="item 4"):
            PA.parse_spec(spec)
    # speculation and re-dispatch have no option until item 7 ports them
    for knob in ({"speculation": object()}, {"redispatch": True}):
        with pytest.raises(ValueError, match="does not match"):
            _engine(P, PA, psplits, pparams, **knob)
    eng = _engine(P, PA, psplits, pparams)
    with pytest.raises(NotImplementedError, match="item 7"):
        eng.inject_schedule([])
    with pytest.raises(NotImplementedError, match="item 4"):
        eng.flush()
    with pytest.raises(ValueError, match="requires 'profile'"):
        PA.parse_spec("tiered")
    with pytest.raises(ValueError, match="does not match"):
        PA.parse_spec("tiered", deadline_s=0.1)


def test_eviction_sweep_matches_reference(zoos):
    engs = [_run(zoos, J), _run(zoos, P)]
    for eng in engs:
        eng.max_sessions = 1
        eng.idle_timeout_s = None
    assert engs[0].evict_sessions(20.0) == engs[1].evict_sessions(20.0) == 2
    assert list(engs[0].sessions) == list(engs[1].sessions)
    assert sorted(k for k, _ in engs[1].cache.entries()) == \
        sorted(k for k, _ in engs[0].cache.entries())


def test_metrics_registry_matches_reference(zoos):
    """Counters, callable gauges and latency histograms of one run."""
    snaps = [_run(zoos, pkg, precision=INT8, crash_at=2.5).metrics
             for pkg in (J, P)]
    a, b = (m.snapshot() for m in snaps)
    assert a["gauges"] == b["gauges"] == {"cache.entries": 9,
                                          "engine.sessions_live": 3}
    assert a["counters"].keys() == b["counters"].keys()
    for k, v in a["counters"].items():
        assert b["counters"][k] == pytest.approx(v, rel=1e-12), k
    for name in ("serve.latency_s", "serve.ttfp_s"):
        ha, hb = (m.histogram(name).summary() for m in snaps)
        assert ha["count"] == hb["count"] > 0
        for q in ("p50", "p95", "p99"):
            assert hb[q] == pytest.approx(ha[q], rel=1e-9)


def test_trace_events_match_reference(zoos):
    names = []
    for pkg in (J, P):
        from repro.obs import Tracer as JTracer
        tr = JTracer() if pkg is J else Tracer()
        _run(zoos, pkg, precision=INT8, tracer=tr)
        names.append([(e.name, e.cat, e.track) for e in tr.events])
    assert names[0] == names[1] and len(names[1]) > 50


# ----------------------------------------------------- policy, transport

def test_multitier_decisions_match_reference():
    for precisions in (None, {"edge64x": ("fp32", "int8"),
                              "ph1": ("fp32", "int8")}):
        pols = []
        for pkg in (J, P):
            mons = {"ph1": pkg.HeartbeatMonitor(pkg.BandwidthTrace.static(
                        pkg.nlos_bandwidth(0.0))),
                    "edge64x": pkg.HeartbeatMonitor(pkg.BandwidthTrace.walk(
                        list(np.linspace(0, 40, 21)), pkg.nlos_bandwidth,
                        period=0.7))}
            pols.append(pkg.MultiTierPolicy(
                pkg.ProfileTable(base=dict(BASE)), mons, local="glass",
                tier_of={t: t for t in TIERS}, precisions=precisions))
        for t in np.linspace(0, 14, 15):
            for sub, nb in (("enc:text", 480000), ("enc:vitals", 720),
                            ("enc:scene", 921600), ("tail", 64)):
                for fb in (0, 256, 1248, 40000):
                    q = {"glass": 0.0, "ph1": 0.01 * t, "edge64x": 0.002}
                    for avail in (None, ["ph1"]):
                        a, b = (p.decide(sub, nb, float(t), queues=q,
                                         available=avail, feat_bytes=fb)
                                for p in pols)
                        assert (a.tier, a.precision) == (b.tier, b.precision)
                        assert list(a.estimates) == list(b.estimates)
                        for n in a.estimates:
                            ea, eb = a.estimates[n], b.estimates[n]
                            assert ea.precision == eb.precision
                            assert eb.cost == pytest.approx(ea.cost,
                                                            rel=1e-12)
                ta, tb = (p.decide_tail(fb + 100, 800, "edge64x", float(t))
                          for p in pols)
                assert ta.tier == tb.tier
                for n in ta.estimates:
                    assert tb.estimates[n].cost == pytest.approx(
                        ta.estimates[n].cost, rel=1e-12)


def test_transport_in_order_delivery_never_decreases():
    """The reference's Hypothesis counterexample: ``arrival + (last -
    arrival)`` lands one ulp below ``last`` there; the port's channel
    delivers at ``max(arrival, last)``, never earlier than before."""
    sends = [(1, 0.6008), (778747, 1.7913), (256000, 1.6046)]
    ch = PT.TransportChannel(P.BandwidthTrace.static(1000.0))
    ref = JT.TransportChannel(J.BandwidthTrace.static(1000.0))
    last = 0.0
    for nbytes, t in sends:
        d, r = ch.send(nbytes, t), ref.send(nbytes, t)
        assert d.t_deliver >= last
        assert d.t_deliver == pytest.approx(r.t_deliver, abs=T_ATOL)
        assert d.queued_s == pytest.approx(r.queued_s, abs=T_ATOL)
        last = d.t_deliver
    assert ch.stats() == ref.stats()


def test_fabric_matches_reference():
    fabs = []
    for pkg, mod in ((J, JT), (P, PT)):
        tr = {"ph1": pkg.BandwidthTrace.static(7e6),
              "edge64x": pkg.BandwidthTrace.walk([0, 10, 30],
                                                 pkg.nlos_bandwidth)}
        fab = mod.TierFabric("glass", tr)
        rng = np.random.default_rng(1)
        for i in range(40):
            src, dst = [("glass", "ph1"), ("edge64x", "glass"),
                        ("ph1", "edge64x")][i % 3]
            fab.channel(src, dst).send(int(rng.integers(0, 200000)),
                                       float(i) * 0.07)
        fabs.append(fab)
    assert fabs[0].stats().keys() == fabs[1].stats().keys()
    for k in fabs[0].stats():
        a, b = fabs[0].stats()[k], fabs[1].stats()[k]
        assert (a["bytes"], a["msgs"]) == (b["bytes"], b["msgs"])
        assert b["busy_s"] == pytest.approx(a["busy_s"], rel=1e-12)
    assert isinstance(fabs[1].trace("ph1", "edge64x"), PT.MinTrace)


# ------------------------------------------------------------- launcher

def test_launcher_serves_tiered_int8_on_cpu(capsys):
    PL.main(["--device", "cpu", "--text-encoder", TEXT, "--engine", "tiered",
             "--tiers", "glass,ph1,edge64x",
             "--precision", "ph1=int8,edge64x=int8", "--outage-at", "4"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("fault schedule: crash edge64x @4.00s")
    assert any("[int8]" in ln for ln in out)
    assert any(ln.startswith("4 sessions, 28 arrivals") for ln in out)
    assert out[-1].startswith("cumulative serving latency") and \
        out[-1].endswith("on cpu")


@pytest.mark.parametrize("argv, msg", [
    (["--engine", "tiered", "--speculate"], "item 7"),
    (["--engine", "tiered", "--redispatch"], "item 7"),
    (["--engine", "tiered", "--chaos-seed", "3"], "item 7"),
    (["--engine", "tiered", "--wall-clock"], "item 4"),
    (["--engine", "stream"], "item 4"),
    (["--engine", "batch+tiered"], "item 4"),
    (["--fleet", "4"], "item 9"),
    (["--engine", "tiered+warp"], "unknown engine spec token 'warp'"),
    (["--engine", "+"], "empty spec"),
    (["--precision", "ph1=int8"], "requires a tiered spec"),
    (["--engine", "tiered", "--precision", "ph1"], "malformed entry"),
    (["--engine", "tiered", "--tiers", "glass,mars"], "unknown tier"),
    (["--engine", "tiered", "--outage-at", "99"], "beyond the episode"),
    (["--engine", "tiered", "--outage-at", "3", "--rejoin-at", "2"],
     "strictly after"),
    (["--engine", "tiered", "--rejoin-at", "2"], "requires --outage-at"),
])
def test_launcher_flag_validation(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        PL.main(["--device", "cpu", "--text-encoder", TEXT, *argv])
