"""The port's observability layer against the JAX reference, on the CPU:
the tests of ``tests/test_obs.py`` and ``tests/test_obs_properties.py``
(tracer defaults, deterministic Chrome export, the metrics registry and
its quantile sketch, the trace-replay auditor on every scenario family,
the streaming tracer, Prometheus export), driven on the port.

Beyond the mirrored tests: the port's traces of a race, a re-dispatch
and a seeded chaos drive pass BOTH auditors (the reference's
``repro.obs.audit.audit_doc``, which imports no JAX, and the port's)
and hold the reference's trace of the same drive event for event (name,
category, track and args; times within 1e-9); two port runs export
byte-equal files; the Prometheus text of a registry equals the
reference's for the same registry.
"""
import itertools
import json
import math

import numpy as np
import pytest

from repro.obs import Metrics as JMetrics
from repro.obs import QuantileSketch as JSketch
from repro.obs import Tracer as JTracer
from repro.obs import audit_doc as jax_audit_doc
from repro.serving import chaos as JC
from repro_torch.core.offload import BandwidthTrace
from repro_torch.obs import (Metrics, QuantileSketch, StreamingTracer,
                             Tracer, audit_doc, audit_file, audit_tracer,
                             jsonl_to_chrome, validate_chrome)
from repro_torch.obs.audit import main as audit_main
from repro_torch.serving import chaos as PC
from repro_torch.serving.transport import TransportChannel
from test_torch_speculation import (ALL, T_ATOL, both,  # noqa: F401
                                    same_engines, sides)

hypothesis = pytest.importorskip(
    "hypothesis", reason="optional dev dep (requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

SETTINGS = dict(max_examples=60, deadline=None)


def _tracer(side):
    return Tracer() if side.is_port else JTracer()


def _episode(side, eng):
    for i, m in enumerate(ALL):
        side.submit(eng, "s0", i, m, float(i))


def _audit_both(eng):
    """The engine's trace passes the port's auditor and the reference's."""
    doc = eng.tracer.to_chrome({"transport": eng.fabric.stats()})
    rep = audit_doc(doc)
    assert rep.ok, rep.violations
    jrep = jax_audit_doc(json.loads(json.dumps(doc)))
    assert jrep.ok, jrep.violations
    assert jrep.checks == rep.checks
    return rep


def _same_value(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return b == pytest.approx(a, abs=T_ATOL)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_value(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_value, a, b))
    return a == b


def same_trace(jtr, ptr):
    """Event for event in program order: name, category, track and args
    equal, times within 1e-9."""
    assert len(jtr.events) == len(ptr.events) > 0
    for a, b in zip(jtr.events, ptr.events):
        assert (a.name, a.cat, a.track, a.seq) == (b.name, b.cat, b.track,
                                                   b.seq)
        assert b.ts == pytest.approx(a.ts, abs=T_ATOL)
        assert (a.dur is None) == (b.dur is None)
        if a.dur is not None:
            assert b.dur == pytest.approx(a.dur, abs=T_ATOL)
        assert a.args.keys() == b.args.keys(), a.name
        for k in a.args:
            assert _same_value(a.args[k], b.args[k]), (a.name, k)


# ====================================================== defaults off

def test_disabled_tracer_is_falsy_noop_default(sides):
    _, pside, _ = sides
    assert not Tracer.disabled and bool(Tracer())
    Tracer.disabled.span("x", "c", 0.0, 1.0)
    Tracer.disabled.instant("y", "c", 0.0)
    assert Tracer.disabled.events == []
    eng = pside.engine()
    pside.submit(eng, "s0", 0, "text", 0.0)
    assert eng.tracer is Tracer.disabled and eng.tracer.events == []


def test_legacy_counters_read_through_registry(sides):
    def drive(side):
        eng = side.engine()
        _episode(side, eng)
        m = eng.metrics
        assert eng.cache.hits == int(m.get("cache.hits")) > 0
        assert eng.cache.duplicate_commits == int(
            m.get("cache.duplicate_commits"))
        assert eng.fallback_count == int(m.get("placement.fallbacks"))
        assert eng.evicted_count == int(m.get("engine.evicted_sessions"))
        for name, ch in eng.fabric.stats().items():
            assert ch["bytes"] == int(m.get(f"transport.{name}.bytes"))
            assert ch["cancelled_msgs"] == int(
                m.get(f"transport.{name}.cancelled_msgs"))
        snap = eng.metrics_snapshot()
        assert set(snap) == {"counters", "gauges", "histograms"}
        assert snap["histograms"]["serve.latency_s"]["count"] == 3
        assert snap["gauges"]["engine.sessions_live"] == 1
        return eng, snap
    (jeng, jsnap), (peng, psnap) = both(sides, drive)
    same_engines(jeng, peng)
    assert jsnap["counters"] == psnap["counters"]
    assert jsnap["gauges"] == psnap["gauges"]


# ============================================== deterministic export

def test_trace_export_is_byte_reproducible(sides, tmp_path):
    def drive(side, n):
        eng = side.engine(tracer=_tracer(side), speculation=side.race())
        _episode(side, eng)
        p = tmp_path / f"{'p' if side.is_port else 'j'}{n}.json"
        eng.tracer.export(p, other_data={"transport": eng.fabric.stats()})
        return eng, p
    jside, pside, _ = sides
    (e1, p1), (e2, p2) = drive(pside, 1), drive(pside, 2)
    assert p1.read_bytes() == p2.read_bytes() and p1.stat().st_size > 0
    jeng, _ = drive(jside, 1)
    same_trace(jeng.tracer, e1.tracer)
    assert audit_file(p1).ok


def test_seq_is_monotone_and_ties_sort_stably():
    tr = Tracer()
    for i in range(5):
        tr.instant("tie", "t", 1.0, track="a", i=i)
    tr.span("before", "t", 0.0, 1.0, track="b")
    doc = tr.to_chrome()
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    seqs = [e["args"]["seq"] for e in evs]
    assert evs[0]["name"] == "before"
    assert [e["args"]["i"] for e in evs[1:]] == list(range(5))
    assert sorted(set(seqs)) == sorted(seqs)


def test_chrome_schema_tracks_and_units(sides):
    _, pside, _ = sides
    eng = pside.engine(tracer=Tracer())
    _episode(pside, eng)
    doc = eng.tracer.to_chrome()
    assert validate_chrome(doc) == []
    assert doc["displayTimeUnit"] == "ms"
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    names = {e["args"]["name"] for e in meta if e["name"] == "thread_name"}
    assert {"cache", "session:s0"} <= names
    assert any(n.startswith("host:") for n in names)
    assert any(n.startswith("link:") for n in names)
    spans = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"] == "text#0"]
    assert len(spans) == 1 and spans[0]["dur"] > 0


# ==================================================== metrics registry

def test_metrics_registry_basics():
    m = Metrics()
    m.inc("a")
    m.inc("a", 2.5)
    assert m.get("a") == 3.5 and m.get("absent") == 0
    m.set_gauge("g", 7)
    m.gauge_fn("live", lambda: 42)
    for v in (1.0, 2.0, 3.0):
        m.observe("h", v)
    snap = m.snapshot()
    assert snap["counters"] == {"a": 3.5}
    assert snap["gauges"] == {"g": 7, "live": 42}
    assert snap["histograms"]["h"]["count"] == 3
    assert snap["histograms"]["h"]["mean"] == pytest.approx(2.0)
    json.dumps(snap)
    m.reset()
    snap = m.snapshot()
    assert snap["counters"] == {} and snap["histograms"] == {}
    assert snap["gauges"] == {"live": 42}


def test_sketch_rank_error_bound_seeded():
    rng = np.random.default_rng(3)
    xs = rng.lognormal(mean=2.0, sigma=1.5, size=4000)
    sk, ref = QuantileSketch(rel_err=0.01), JSketch(rel_err=0.01)
    for x in xs:
        sk.add(float(x))
        ref.add(float(x))
    srt = np.sort(xs)
    for q in (0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        true = float(srt[int(np.floor(q * (len(xs) - 1)))])
        got = sk.quantile(q)
        assert abs(got - true) <= 1.01 * sk.rel_err * true, q
        assert got == ref.quantile(q)
    assert sk.state() == ref.state()


def _seeded_sketches(cls, rel_err=0.02):
    rng = np.random.default_rng(4)
    out = []
    for _ in range(3):
        sk = cls(rel_err=rel_err)
        for x in rng.uniform(0.0, 50.0, size=200):
            sk.add(float(x))
        out.append(sk)
    return out


def test_sketch_merge_is_associative_on_state():
    a, b, c = _seeded_sketches(QuantileSketch)
    left, right = a.merge(b).merge(c), a.merge(b.merge(c))
    assert left.state() == right.state()
    for q in (0.1, 0.5, 0.99):
        assert left.quantile(q) == right.quantile(q)
    ja, jb, jc = _seeded_sketches(JSketch)
    assert left.state() == ja.merge(jb).merge(jc).state()
    assert (left.count, left.min, left.max) == (600, ja.merge(jb).merge(
        jc).min, ja.merge(jb).merge(jc).max)
    with pytest.raises(ValueError):
        a.merge(QuantileSketch(rel_err=0.01))
    with pytest.raises(TypeError):
        a.merge(ja)


def _registry(cls):
    rng = np.random.default_rng(5)
    m = cls(rel_err=0.01)
    for i in range(40):
        m.inc(f"c.{i % 7}", float(rng.integers(1, 9)))
        m.observe(f"h-{i % 3}", float(rng.lognormal(0.0, 1.0)))
    m.set_gauge("g.x", 3)
    m.gauge_fn("g.live", lambda: 11)
    m.inc("cache.hits", 3)
    m.inc("cache_hits", 5)
    m.set_gauge("cache.hits", 7)
    m.observe("empty", 1.0)
    m._hists["empty"] = (QuantileSketch if cls is Metrics else JSketch)(0.01)
    return m


def test_prometheus_text_equals_reference():
    got, want = _registry(Metrics), _registry(JMetrics)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.to_prometheus(prefix="") == want.to_prometheus(prefix="")
    merged = Metrics.merged([got, _registry(Metrics)])
    jmerged = JMetrics.merged([want, _registry(JMetrics)])
    assert merged.to_prometheus() == jmerged.to_prometheus()
    assert merged.snapshot() == jmerged.snapshot()
    assert Metrics.merged([]).snapshot() == JMetrics.merged([]).snapshot()
    with pytest.raises(ValueError):
        Metrics.merged([Metrics(rel_err=0.01), Metrics(rel_err=0.02)])


# ============================================ auditor: scenario families

def test_audit_all_lag_scenarios_stream(sides):
    _, pside, _ = sides
    from repro_torch.core import LAG_SCENARIOS, async_episode
    eng = pside.api.build_engine(pside.splits, pside.params, "stream",
                                 share_encoders=True, max_history=None,
                                 tracer=Tracer(), device="cpu")
    eps = {name: async_episode(name, seed=i)
           for i, name in enumerate(sorted(LAG_SCENARIOS))}
    eng.run_arrivals(eps, lambda sid, ev: pside.payloads[ev.modality],
                     sim_window=0.0)
    rep = audit_tracer(eng.tracer)
    assert rep.ok, rep.violations
    assert rep.checks["fuses"] > 0 and rep.checks["emits"] > 0
    assert jax_audit_doc(eng.tracer.to_chrome()).ok


def test_audit_placement_sweep_81(sides):
    _, pside, _ = sides
    submods = ("enc:text", "enc:vitals", "enc:scene", "tail")
    total = dict.fromkeys(("commits", "fuses", "flights"), 0)
    for combo in itertools.product(("glass", "ph1", "edge64x"),
                                   repeat=len(submods)):
        eng = pside.engine(tracer=Tracer(), force=dict(zip(submods, combo)))
        _episode(pside, eng)
        rep = _audit_both(eng)
        for k in total:
            total[k] += rep.checks[k]
    assert total["commits"] >= 81 * 3 and total["fuses"] >= 81 * 3
    assert total["flights"] > 0


def test_audit_speculation_remote_wins(sides):
    def drive(side):
        eng = side.engine(tracer=_tracer(side), speculation=side.race())
        _episode(side, eng)
        assert eng.spec_count == 3
        return eng
    jeng, peng = both(sides, drive)
    rep = _audit_both(peng)
    assert rep.checks["flights"] > 0
    names = [e.name for e in peng.tracer.events]
    assert names.count("race.start") == names.count("race.win") == 3
    assert "host.release" in names
    same_trace(jeng.tracer, peng.tracer)


def test_audit_speculation_glass_wins_cancelled_flight(sides):
    def drive(side):
        eng = side.engine(trace=side.pkg.BandwidthTrace.static(200.0),
                          tier_traces={}, speculation=side.race(),
                          tracer=_tracer(side))
        rec = side.submit(eng, "s0", 0, "text", 0.0)
        assert rec.race_winner == "glass"
        return eng
    jeng, peng = both(sides, drive)
    assert _audit_both(peng).checks["cancels"] == 1
    same_trace(jeng.tracer, peng.tracer)


def test_audit_redispatch_cascade(sides):
    def drive(side):
        eng = side.engine(tracer=_tracer(side), redispatch=True)
        eng.inject_crash(2.1, "edge64x")
        eng.inject_crash(3.1, "ph1")
        _episode(side, eng)
        assert eng.redispatch_count == 1
        return eng
    jeng, peng = both(sides, drive)
    _audit_both(peng)
    names = {e.name for e in peng.tracer.events}
    assert {"crash.inject", "crash.detect", "redispatch"} <= names
    same_trace(jeng.tracer, peng.tracer)


def test_audit_seeded_chaos_schedule(sides):
    def drive(side):
        pkg, chaos = side.pkg, PC if side.is_port else JC
        eps = {f"s{i}": pkg.async_episode("text_first", seed=i)
               for i in range(2)}
        sched = chaos.chaos_schedule(5, horizon=pkg.horizon(eps),
                                     tiers=("ph1", "edge64x"),
                                     mean_up_s=1.5, mean_down_s=0.6,
                                     min_up_s=0.4, min_down_s=0.3)
        eng = side.engine(tracer=_tracer(side), redispatch=True,
                          speculation=side.race())
        eng.run_arrivals(eps, lambda sid, ev: side.payloads[ev.modality],
                         schedule=sched)
        assert eng.rejoin_count >= 1
        return eng
    jeng, peng = both(sides, drive)
    rep = _audit_both(peng)
    names = {e.name for e in peng.tracer.events}
    assert {"crash.inject", "rejoin"} <= names
    assert rep.checks["commits"] > 0 and rep.checks["flights"] > 0
    same_engines(jeng, peng)
    same_trace(jeng.tracer, peng.tracer)


# ================================================= auditor: tampering

def _minimal_doc():
    tr = Tracer()
    tr.instant("cache.commit", "cache", 0.0, track="cache", key="s0",
               modality="text", step=0, tier="glass", accepted=True,
               version=0)
    tr.span("transport.flight", "transport", 0.0, 1.0, track="link:u",
            flight=0, channel="u", nbytes=100, t_send=0.0, t_deliver=1.0,
            queued_s=0.0)
    tr.instant("transport.cancel", "transport", 0.5, track="link:u",
               flight=0, channel="u", nbytes=100, t=0.5)
    tr.instant("fuse", "serve", 1.0, track="session:s0", key="s0",
               model="text", step=0, consumed={"text": [0, 0]})
    tr.instant("emit", "serve", 1.0, track="session:s0", key="s0",
               model="text", step=0, kind="partial")
    return tr.to_chrome()


@pytest.mark.parametrize("name, field, value, code", [
    ("cache.commit", "version", 3, "I1"),
    ("fuse", "consumed", {"text": [5, 5]}, "I4"),
    ("fuse", "consumed", {"text": [0, 2]}, "I2"),
    ("transport.cancel", "t", 1.0, "I3"),
    ("emit", "key", "ghost", "I4")])
def test_audit_accepts_minimal_doc_then_catches_tampering(name, field,
                                                          value, code):
    doc = _minimal_doc()
    assert audit_doc(doc).ok
    d = json.loads(json.dumps(doc))
    next(e for e in d["traceEvents"]
         if e.get("name") == name)["args"][field] = value
    got = audit_doc(d).violations
    assert any(code in v for v in got)
    assert got == jax_audit_doc(d).violations
    assert next(e for e in doc["traceEvents"]
                if e.get("name") == "emit")["args"]["key"] == "s0"


def test_audit_cli_exit_codes(sides, tmp_path, capsys):
    _, pside, _ = sides
    eng = pside.engine(tracer=Tracer())
    _episode(pside, eng)
    clean = tmp_path / "clean.json"
    eng.tracer.export(clean, other_data={"transport": eng.fabric.stats()})
    assert audit_main([str(clean)]) == 0
    assert "audit OK" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nope": 1}))
    assert audit_main([str(bad)]) == 2
    doc = json.loads(clean.read_text())
    for e in doc["traceEvents"]:
        if e.get("name") == "emit":
            e["args"]["key"] = "ghost"
    tampered = tmp_path / "tampered.json"
    tampered.write_text(json.dumps(doc))
    assert audit_main([str(tampered)]) == 1


# =============================== byte conservation, random cancels

def test_byte_conservation_under_random_cancel_schedule():
    rng = np.random.default_rng(7)
    tr = Tracer()
    ch = TransportChannel(BandwidthTrace.static(1e4), name="g->e",
                          metrics=Metrics(), tracer=tr, max_history=None)
    t = 0.0
    for _ in range(60):
        t += float(rng.uniform(0.0, 0.05))
        d = ch.send(int(rng.integers(1, 5000)), t)
        if rng.random() < 0.4:
            ch.cancel(d.flight, d.t_send + 0.9 * float(rng.random())
                      * (d.t_deliver - d.t_send))
    assert ch.cancelled_msgs > 0
    rep = audit_doc(tr.to_chrome({"transport": {ch.name: ch.stats()}}))
    assert rep.ok, rep.violations
    assert rep.checks["flights"] == 60
    assert rep.checks["cancels"] == ch.cancelled_msgs
    bad = {ch.name: dict(ch.stats(), bytes=ch.stats()["bytes"] + 1)}
    assert not audit_doc(tr.to_chrome({"transport": bad})).ok


# ====================================== streaming (bounded) tracer

def _record_mixed(tr, n=100):
    high = 0
    for i in range(n):
        if i % 3 == 0:
            tr.span(f"work#{i}", "w", i * 0.01, i * 0.01 + 0.002,
                    track=f"r{i % 2}", i=i)
        else:
            tr.instant(f"mark#{i}", "m", i * 0.01, track="fleet", i=i)
        high = max(high, len(tr.events))
    return high


def test_streaming_tracer_bounded_ring_and_exact_roundtrip(tmp_path):
    plain = Tracer()
    _record_mixed(plain)
    p = tmp_path / "stream.jsonl"
    st_ = StreamingTracer(p, buffer=8)
    assert _record_mixed(st_) <= 8          # O(buffer), never O(events)
    other = {"metrics": {"counters": {"x": 1}}}
    assert st_.close(other_data=other) == 100
    assert st_.close() == 100               # idempotent
    assert jsonl_to_chrome(p) == plain.to_chrome(other)
    rep = audit_file(p)
    assert rep.ok, rep.violations


def test_streaming_tracer_guards(tmp_path):
    with pytest.raises(ValueError, match="buffer"):
        StreamingTracer(tmp_path / "x.jsonl", buffer=0)
    p = tmp_path / "t.jsonl"
    with StreamingTracer(p, buffer=4) as st_:
        st_.instant("a", "t", 0.0)
        with pytest.raises(ValueError, match="jsonl_to_chrome"):
            st_.export(tmp_path / "elsewhere.json")
    assert st_.export() == 1
    assert len(jsonl_to_chrome(p)["traceEvents"]) == 3  # 2 meta + 1 event


def test_streaming_trace_audits_like_the_inmemory_export(sides, tmp_path):
    _, pside, _ = sides
    p = tmp_path / "tiered.jsonl"
    eng = pside.engine(tracer=StreamingTracer(p, buffer=16),
                       speculation=pside.race())
    _episode(pside, eng)
    stats = {"transport": eng.fabric.stats()}
    n_stream = eng.tracer.export(other_data=stats)
    ref = pside.engine(tracer=Tracer(), speculation=pside.race())
    _episode(pside, ref)
    assert n_stream == len(ref.tracer.events) > 16   # the ring spilled
    assert jsonl_to_chrome(p) == ref.tracer.to_chrome(stats)
    rep = audit_file(p)
    assert rep.ok, rep.violations
    assert audit_main([str(p)]) == 0


# ============================ transport and metrics seams (regressions)

def test_cancel_survives_history_pruning():
    ch = TransportChannel(BandwidthTrace.static(1e6), latency_s=0.0,
                          overhead_bytes=0, max_history=4)
    big = ch.send(int(1e7), 0.0)                    # 10 s on the wire
    assert big.t_deliver >= 10.0
    for i in range(100):
        ch.send(100, 0.001 * (i + 1))
    assert ch.cancel(big.flight, 5.0) is True
    assert big.cancelled
    for i in range(100):
        ch.send(100, 20.0 + 0.001 * i)
    assert len(ch._flights) <= 4 * ch.max_history + 1


def test_prometheus_collision_disambiguated():
    m = Metrics()
    m.inc("cache.hits", 3)
    m.inc("cache_hits", 5)
    m.set_gauge("cache.hits", 7)
    text = m.to_prometheus()
    type_lines = [ln for ln in text.splitlines() if ln.startswith("# TYPE")]
    names = [ln.split()[2] for ln in type_lines]
    assert len(names) == len(set(names)) == 3
    assert "emsserve_cache_hits 3.0" in text
    assert "emsserve_cache_hits_2 5.0" in text
    assert "emsserve_cache_hits_3 7.0" in text
    assert m.to_prometheus() == text


def test_sketch_boundary_value_keeps_error_bound():
    s = QuantileSketch(rel_err=0.01)
    v = s._gamma ** 16
    s.add(v)
    s.add(10.0 * v)
    assert abs(s.quantile(0.0) - v) <= s.rel_err * v
    assert s._buckets.get(16) == 1


# ========================================= properties (Hypothesis)

values = st.floats(min_value=0.0, max_value=1e9, allow_nan=False,
                   allow_infinity=False)


@settings(**SETTINGS)
@given(xs=st.lists(values, min_size=1, max_size=300),
       q=st.floats(min_value=0.0, max_value=1.0),
       rel_err=st.sampled_from([0.005, 0.01, 0.05]))
def test_quantile_rank_error_bound(xs, q, rel_err):
    sk, ref = QuantileSketch(rel_err=rel_err), JSketch(rel_err=rel_err)
    for x in xs:
        sk.add(x)
        ref.add(x)
    got = sk.quantile(q)
    true = sorted(xs)[int(math.floor(q * (len(xs) - 1)))]
    if true < 1e-12:
        assert got <= true * (1 + rel_err) + 1e-12
    else:
        assert abs(got - true) <= rel_err * true + 1e-9
    assert got == ref.quantile(q)


@settings(**SETTINGS)
@given(parts=st.lists(st.lists(values, max_size=80), min_size=3,
                      max_size=3))
def test_merge_is_associative_and_commutative_on_state(parts):
    sks = []
    for xs in parts:
        sk = QuantileSketch(rel_err=0.01)
        for x in xs:
            sk.add(x)
        sks.append(sk)
    a, b, c = sks
    assert a.merge(b).merge(c).state() == a.merge(b.merge(c)).state()
    assert a.merge(b).state() == b.merge(a).state()
    assert a.merge(b).merge(c).count == sum(len(p) for p in parts)


@settings(**SETTINGS)
@given(schedule=st.lists(
    st.tuples(st.integers(min_value=1, max_value=100000),
              st.floats(min_value=0.001, max_value=0.2),
              st.one_of(st.none(),
                        st.floats(min_value=0.0, max_value=0.999))),
    min_size=1, max_size=40))
def test_byte_conservation_under_random_cancel_schedules(schedule):
    tr = Tracer()
    ch = TransportChannel(BandwidthTrace.static(5e4), name="g->e",
                          metrics=Metrics(), tracer=tr, max_history=None)
    t = 0.0
    for nbytes, gap, frac in schedule:
        t += gap
        d = ch.send(nbytes, t)
        if frac is not None:
            assert ch.cancel(d.flight,
                             d.t_send + frac * (d.t_deliver - d.t_send))
    s = ch.stats()
    doc = tr.to_chrome({"transport": {ch.name: s}})
    rep = audit_doc(doc)
    assert rep.ok, rep.violations
    assert jax_audit_doc(doc).ok
    assert (sum(d.nbytes for d in ch.completed()) + s["cancelled_bytes"]
            == s["bytes"])
    assert len(ch.completed()) + s["cancelled_msgs"] == s["msgs"]
    assert rep.checks["flights"] == len(schedule)


@settings(**SETTINGS)
@given(i=st.integers(min_value=-200, max_value=400),
       rel_err=st.sampled_from([0.005, 0.01, 0.02, 0.05]))
def test_boundary_values_land_in_their_own_bucket(i, rel_err):
    sk = QuantileSketch(rel_err=rel_err)
    v = sk._gamma ** i
    if not (v >= 1e-12 and math.isfinite(v)):
        return
    sk.add(v)
    assert sk._buckets == {i: 1}


# ============================================================ launcher

def test_launcher_traces_a_chaos_drive_on_cpu(tmp_path, capsys):
    """The launcher's robust command serves on the CPU, writes an
    auditable trace and a Prometheus page."""
    from repro_torch.launch import serve as PL
    trace, prom = tmp_path / "robust.json", tmp_path / "robust.prom"
    PL.main(["--device", "cpu", "--text-encoder", "microbert", "--engine",
             "tiered", "--tiers", "glass,ph1,edge64x", "--precision",
             "ph1=int8,edge64x=int8", "--speculate", "--redispatch",
             "--chaos-seed", "5", "--trace", str(trace), "--metrics-out",
             str(prom)])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("fault schedule: chaos seed 5,")
    assert any(ln.startswith("4 sessions, 28 arrivals") for ln in out)
    assert any(ln.startswith("speculation: ") for ln in out)
    assert out[-1].startswith("trace: ") and "repro_torch.obs.audit" in out[-1]
    assert audit_main([str(trace)]) == 0
    doc = json.loads(trace.read_text())
    assert jax_audit_doc(doc).ok
    assert set(doc["otherData"]) == {"metrics", "transport"}
    text = prom.read_text()
    assert "# TYPE emsserve_placement_rejoins counter" in text
    assert "emsserve_serve_latency_s_count 28" in text
