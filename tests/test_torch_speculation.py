"""Speculative dual placement of the port against the JAX reference, on
the CPU: the seven claims of ``tests/test_speculation.py``, each driven
through both packages' tiered engines.

Both engines serve the tiny 7-model zoo (``text_encoder="microbert"``)
over ONE shared parameter dict (the JAX initialiser's weights converted
through numpy) with one fixed ``ProfileTable`` and the same numpy
payloads. Records agree exactly in every placement field (tier, enc/tail
tier, kind, fallback, ``speculative``, ``race_winner``); times within
1e-9 (the port's in-order delivery is ``max(arrival, last)``, one ulp
from the reference's sum); outputs within 1e-5 (float32 flights);
speculation statistics, link bytes and the cache's (step, version, tier)
exactly.
"""
import jax
import numpy as np
import pytest

import repro.core as J
from repro.configs.emsnet import tiny as jax_tiny
from repro.core.offload import SpeculationPolicy as JSpeculation
from repro.models import emsnet as JE
from repro.serving import api as JA
from repro_torch import core as P
from repro_torch.configs.emsnet import tiny
from repro_torch.convert import from_jax_numpy
from repro_torch.serving import api as PA

TEXT = "microbert"
ALL = ("text", "vitals", "scene")
TIERS = ("glass", "ph1", "edge64x")
BASE = {"enc:text": 0.08, "enc:vitals": 0.01, "enc:scene": 0.05,
        "tail": 0.005, "full": 0.15}
FP32_ATOL = 1e-5
INT8_ATOL = 1e-4
T_ATOL = 1e-9


class Side:
    """One package's tiered-engine surface over the shared weights."""

    def __init__(self, pkg, api, spec_cls, splits, params, payloads):
        self.pkg, self.api, self.spec_cls = pkg, api, spec_cls
        self.splits, self.params, self.payloads = splits, params, payloads
        self.is_port = api is PA

    def engine(self, spec="tiered", *, bandwidth=5.0, **kw):
        pkg = self.pkg
        kw.setdefault("max_history", None)
        kw.setdefault("tier_traces", {"ph1": pkg.BandwidthTrace.static(
            pkg.nlos_bandwidth(0.0))})
        kw.setdefault("trace", pkg.BandwidthTrace.static(
            pkg.nlos_bandwidth(bandwidth)))
        kw.setdefault("tiers", TIERS)
        if self.is_port:
            kw["device"] = "cpu"
        return self.api.build_engine(
            self.splits, self.params, spec, share_encoders=True,
            profile=pkg.ProfileTable(base=dict(BASE)), **kw)

    def race(self, deadline_s=0.0, margin_s=0.0):
        return self.spec_cls(deadline_s=deadline_s, margin_s=margin_s)

    def submit(self, eng, sid, i, m, t):
        return eng.submit(sid, self.pkg.Event(i, m, t), self.payloads[m])


@pytest.fixture(scope="module")
def sides():
    jcfg, cfg = jax_tiny(text_encoder=TEXT), tiny(text_encoder=TEXT)
    jzoo = J.emsnet_zoo(jcfg)
    jshared = jzoo["text+vitals+scene"].init_fn(jax.random.PRNGKey(0))
    pshared = from_jax_numpy(jax.device_get(jshared), "cpu")
    rng = np.random.default_rng(0)
    payloads = {
        "text": rng.integers(1, cfg.vocab_size, (1, 11)).astype(np.int32),
        "vitals": rng.normal(size=(1, 5, cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }
    jside = Side(J, JA, JSpeculation,
                 {k: J.split(m) for k, m in jzoo.items()},
                 {k: jshared for k in jzoo}, payloads)
    pside = Side(P, PA, P.SpeculationPolicy,
                 {k: P.split(m) for k, m in P.emsnet_zoo(cfg).items()},
                 {k: pshared for k in jzoo}, payloads)
    return jside, pside, (jcfg, jshared)


def _key(r):
    return (r.sid, r.index, r.model, r.tier, r.enc_tier, r.tail_tier,
            r.precision, r.kind, r.fallback, r.speculative, r.race_winner)


def same_engines(jeng, peng):
    """Records, race and placement statistics, link bytes and the glass
    cache of the two packages' engines agree."""
    assert len(jeng.records) == len(peng.records) > 0
    for a, b in zip(jeng.records, peng.records):
        assert _key(a) == _key(b)
        for f in ("t_start", "t_emit", "detect_s", "uplink_s",
                  "downlink_s", "compute_s"):
            assert getattr(b, f) == pytest.approx(getattr(a, f),
                                                  abs=T_ATOL), f
        assert (a.race_loser_emit is None) == (b.race_loser_emit is None)
        if a.race_loser_emit is not None:
            assert b.race_loser_emit == pytest.approx(a.race_loser_emit,
                                                      abs=T_ATOL)
        assert a.decision.speculate == b.decision.speculate
        assert (a.outputs is None) == (b.outputs is None)
        if a.outputs is not None:
            atol = INT8_ATOL if a.precision == "int8" else FP32_ATOL
            for k in a.outputs:
                np.testing.assert_allclose(b.outputs[k].numpy(),
                                           np.asarray(a.outputs[k]),
                                           atol=atol, rtol=0)
    assert jeng.speculation_stats() == peng.speculation_stats()
    assert jeng.placement_counts() == peng.placement_counts()
    assert jeng.tail_placement_counts() == peng.tail_placement_counts()
    assert (jeng.fallback_count, jeng.rejoin_count) == \
        (peng.fallback_count, peng.rejoin_count)
    jl, pl = jeng.fabric.stats(), peng.fabric.stats()
    assert list(jl) == list(pl)
    for link in jl:
        for f in ("bytes", "msgs", "cancelled_msgs", "cancelled_bytes"):
            assert jl[link][f] == pl[link][f], (link, f)
    jc = {k: (e.step, e.version, e.tier) for k, e in jeng.cache.entries()}
    pc = {k: (e.step, e.version, e.tier) for k, e in peng.cache.entries()}
    assert jc == pc
    for n in jeng.hosts:
        assert peng.hosts[n].busy_s == pytest.approx(jeng.hosts[n].busy_s,
                                                     abs=T_ATOL)
        assert peng.hosts[n].free_at == pytest.approx(
            jeng.hosts[n].free_at, abs=T_ATOL)
    assert jeng._replica_versions == peng._replica_versions


def both(sides, drive):
    """``drive(side)`` on the reference and on the port; the results."""
    jside, pside, _ = sides
    return drive(jside), drive(pside)


def _episode(side, eng, sid="s0"):
    return [side.submit(eng, sid, i, m, float(i)) for i, m in enumerate(ALL)]


def _reference_parity(rec, sides, observed):
    """A port record's outputs against the reference model's forward over
    its observed subset (finals: the full fused forward)."""
    jside, _, (jcfg, jshared) = sides
    if set(observed) == set(ALL):
        want = JE.forward(jshared, jcfg, jside.payloads)
    else:
        want = JE.partial_forward(jshared, jcfg, jside.payloads, observed)
    for k in want:
        np.testing.assert_allclose(rec.outputs[k].numpy(),
                                   np.asarray(want[k]), atol=FP32_ATOL)


def test_speculation_off_by_default(sides):
    def drive(side):
        eng = side.engine()
        rec = side.submit(eng, "s0", 0, "text", 0.0)
        assert not rec.speculative and rec.race_winner is None
        assert not rec.decision.speculate
        assert eng.spec_count == 0
        return eng
    same_engines(*both(sides, drive))


def test_race_commits_once_remote_wins(sides):
    def drive(side):
        eng = side.engine(speculation=side.race())
        for rec in _episode(side, eng):
            assert rec.speculative and rec.race_winner == rec.tier
            assert rec.race_winner != "glass"      # the fast remote wins
            assert rec.race_loser_emit > rec.t_emit
        assert eng.spec_count == 3
        assert sum(eng.spec_wins.values()) == 3 and eng.spec_wins["glass"] == 0
        ss = eng.speculation_stats()
        assert ss["duplicate_commits"] == 0 and ss["stale_commits"] == 0
        # the glass racer's booking was released: less than 3 full racers
        full_racer = (sum(eng.glass.time(f"enc:{m}") for m in ALL)
                      + 3 * eng.glass.time("tail"))
        assert eng.glass.busy_s < full_racer
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    observed = []
    for rec, m in zip(peng.records, ALL):
        observed.append(m)
        _reference_parity(rec, sides, observed)


def test_race_glass_wins_cancels_inflight_uplink(sides):
    def drive(side):
        eng = side.engine(trace=side.pkg.BandwidthTrace.static(200.0),
                          tier_traces={}, speculation=side.race())
        rec = side.submit(eng, "s0", 0, "text", 0.0)
        assert rec.speculative and rec.race_winner == "glass"
        assert rec.race_loser_emit > rec.t_emit
        up = eng.fabric.channel("glass", rec.decision.best_remote)
        assert up.cancelled_msgs == 1 and up.cancelled_bytes > 0
        assert up.completed() == []              # nothing ever delivered
        assert eng.hosts[rec.decision.best_remote].busy_s == 0.0
        ss = eng.speculation_stats()
        assert ss["cancelled_msgs"] == 1 and ss["duplicate_commits"] == 0
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    _reference_parity(peng.records[0], sides, ("text",))


def test_race_absorbs_crash_without_detection_stall(sides):
    def drive(side):
        eng = side.engine(speculation=side.race())
        eng.inject_crash(0.05, "edge64x")
        rec = side.submit(eng, "s0", 0, "text", 0.0)
        assert rec.speculative and rec.race_winner == "glass"
        assert not rec.fallback and rec.detect_s == 0.0
        assert eng.spec_crash_saves == 1 and eng.fallback_count == 0
        plain = side.engine()
        plain.inject_crash(0.05, "edge64x")
        rec2 = side.submit(plain, "s0", 0, "text", 0.0)
        assert rec2.fallback and rec2.detect_s > 0.0
        assert rec.latency_s < rec2.latency_s       # the hedge pays
        return eng, plain
    (jeng, jplain), (peng, pplain) = both(sides, drive)
    same_engines(jeng, peng)
    same_engines(jplain, pplain)
    _reference_parity(peng.records[0], sides, ("text",))


def test_race_loser_late_result_cannot_regress_cache(sides):
    def drive(side):
        eng = side.engine(speculation=side.race())
        side.submit(eng, "s0", 0, "text", 0.0)
        side.submit(eng, "s0", 1, "text", 1.0)
        e = eng.cache.peek("s0", "text")
        step, version = e.step, e.version
        # the losing racer's commit (same step), then a straggler
        assert not eng.cache.put("s0", "text", e.feature, step=step,
                                 tier="glass")
        assert not eng.cache.put("s0", "text", e.feature, step=step - 1,
                                 tier="edge64x")
        e2 = eng.cache.peek("s0", "text")
        assert (e2.step, e2.version) == (step, version)
        assert eng.cache.duplicate_commits == 1
        assert eng.cache.stale_commits == 1
        return eng
    same_engines(*both(sides, drive))


def test_race_under_stream_glass_partials(sides):
    def drive(side):
        eng = side.engine("stream+tiered", speculation=side.race())
        for rec in _episode(side, eng):
            assert rec.speculative and rec.glass_partial is None
        assert eng.spec_count == 3
        assert eng.speculation_stats()["duplicate_commits"] == 0
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    for a, b in zip(jeng.sessions["s0"].predictions,
                    peng.sessions["s0"].predictions):
        assert (a.model, a.step, a.kind) == (b.model, b.step, b.kind)
        assert b.t_emit == pytest.approx(a.t_emit, abs=T_ATOL)


def test_margin_thresholds_gate_racing(sides):
    def drive(side):
        lazy = side.engine(speculation=side.race(deadline_s=1e3))
        rec = side.submit(lazy, "s0", 0, "text", 0.0)
        assert not rec.speculative and lazy.spec_count == 0
        assert rec.decision.margin_s > 0.0
        tight = side.engine(speculation=side.race(deadline_s=1e-6))
        rec2 = side.submit(tight, "s0", 0, "text", 0.0)
        assert rec2.speculative and tight.spec_count == 1
        return lazy, tight, rec.decision.margin_s
    (jl, jt, jm), (pl, pt, pm) = both(sides, drive)
    same_engines(jl, pl)
    same_engines(jt, pt)
    assert pm == pytest.approx(jm, abs=T_ATOL)
