"""Fault injection on the port's tiered engine against the JAX reference,
on the CPU: the eleven tests of ``tests/test_fault_injection.py`` (crash
-> heartbeat-detected failover -> rejoin with replica re-warm ->
re-crash; mid-flight re-dispatch; seeded chaos schedules), each driven
through both packages, and the chaos generator held to the reference's
schedules seed for seed.

The engines, weights, payloads and tolerances are those of
``test_torch_speculation.py`` (float32 flights 1e-5, times 1e-9,
placement fields, statistics and cache versions exact).
"""
import pytest

from repro.serving import chaos as JC
from repro_torch.serving import chaos as PC
from test_torch_speculation import (ALL, _reference_parity,  # noqa: F401
                                    both, same_engines, sides)


def _script(side, eng, script, sid="s0"):
    return [side.submit(eng, sid, i, m, t)
            for i, (m, t) in enumerate(script)]


def _observed_parity(recs, sides):
    """Every port emission against the reference forward over the
    session's observed subset, finals included."""
    observed = {}
    for r in recs:
        obs = observed.setdefault(r.sid, [])
        if r.modality not in obs:
            obs.append(r.modality)
        assert r.kind == ("final" if set(obs) == set(ALL) else "partial")
        _reference_parity(r, sides, obs)


def test_crash_failover_rejoin_recrash_scenario(sides):
    script = [("text", 0.0, "edge64x", False),
              ("vitals", 1.0, "edge64x", False),
              ("scene", 2.0, "glass", True),     # dies in flight at 2.1
              ("vitals", 4.0, "ph1", False),     # outage: next-best
              ("vitals", 9.0, "edge64x", False)]  # rejoined, re-selected

    def drive(side):
        eng = side.engine()
        eng.inject_crash(2.1, "edge64x", rejoin_at=8.0)
        recs = _script(side, eng, [(m, t) for m, t, _, _ in script])
        for rec, (m, t, tier, fb) in zip(recs, script):
            assert (rec.enc_tier, rec.fallback) == (tier, fb), (m, t)
        assert recs[2].detect_s == pytest.approx(1.0)
        assert recs[2].t_start >= 3.0
        assert eng.fallback_count == 1 and eng.rejoin_count == 1
        assert not eng._faults["edge64x"].dead
        versions = eng._replica_versions["edge64x"]
        for (key, m), e in eng.cache.entries():
            assert versions[(key, m)] == e.version
        assert eng.fabric.channel("glass", "edge64x").bytes_sent > 0
        st = eng.sessions["s0"]
        for (key, m), e in eng.cache.entries():
            assert st.input_step[m] - e.step <= 1
        # re-crash the rejoined tier: a second failover
        eng.inject_crash(10.2, "edge64x")
        rec = side.submit(eng, "s0", 5, "scene", 10.0)
        assert rec.fallback and rec.enc_tier == "glass"
        assert rec.detect_s == pytest.approx(1.0)
        rec = side.submit(eng, "s0", 6, "vitals", 11.5)
        assert rec.enc_tier == "ph1" and not rec.fallback
        assert eng.fallback_count == 2 and eng.rejoin_count == 1
        assert eng.placement_counts() == {"glass": 2, "ph1": 2,
                                          "edge64x": 3, "fallbacks": 2}
        assert eng.tail_placement_counts() == {"glass": 2, "ph1": 2,
                                               "edge64x": 3}
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    _observed_parity(peng.records, sides)


def test_eviction_drops_every_tier_replica(sides):
    def drive(side):
        eng = side.engine("stream+tiered", max_sessions=1)
        _script(side, eng, [(m, float(i)) for i, m in enumerate(ALL)])
        assert any(k[0] == "s0" for vers in eng._replica_versions.values()
                   for k in vers)
        side.submit(eng, "s1", 0, "text", 20.0)
        assert eng.evicted_count == 1 and set(eng.sessions) == {"s1"}
        assert not any(k[0] == "s0"
                       for vers in eng._replica_versions.values()
                       for k in vers)
        assert ("s0", "text") not in eng.cache
        return eng
    same_engines(*both(sides, drive))


def test_rejoined_tier_wins_only_when_fastest(sides):
    def drive(side):
        eng = side.engine()
        eng.inject_crash(0.5, "edge64x", rejoin_at=2.0)
        assert side.submit(eng, "s0", 0, "text", 0.4).fallback
        rec = side.submit(eng, "s0", 1, "vitals", 4.0)
        assert rec.enc_tier == "edge64x" and eng.rejoin_count == 1
        eng.hosts["edge64x"].free_at = 1e6        # a deep queue
        rec = side.submit(eng, "s0", 2, "vitals", 5.0)
        assert rec.enc_tier == "ph1"
        return eng
    same_engines(*both(sides, drive))


def test_crash_before_any_traffic_then_rejoin(sides):
    def drive(side):
        eng = side.engine()
        eng.inject_crash(0.1, "edge64x", rejoin_at=1.0)
        rec = side.submit(eng, "s0", 0, "text", 2.0)
        assert rec.enc_tier == "edge64x" and not rec.fallback
        assert eng.rejoin_count == 1
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    _reference_parity(peng.records[0], sides, ("text",))


def test_rejoin_requires_crash_and_future_time(sides):
    def drive(side):
        eng = side.engine()
        eng.inject_crash(5.0, "edge64x")
        msgs = []
        for call in (lambda: eng.schedule_rejoin(4.0, "edge64x"),
                     lambda: eng.run_arrivals({}, lambda s, e: None,
                                              rejoin_at=1.0)):
            with pytest.raises(ValueError) as e:
                call()
            msgs.append(str(e.value))
        return msgs
    jmsgs, pmsgs = both(sides, drive)
    assert jmsgs == pmsgs


def test_redispatch_lost_flight_to_surviving_remote(sides):
    def drive(side):
        eng = side.engine(redispatch=True)
        eng.inject_crash(2.1, "edge64x")
        _script(side, eng, [("text", 0.0), ("vitals", 1.0)])
        rec = side.submit(eng, "s0", 2, "scene", 2.0)
        assert rec.fallback and rec.enc_tier == "ph1"
        assert rec.detect_s == pytest.approx(1.0)
        assert rec.t_start >= 3.0
        assert eng.redispatch_count == 1 and eng.fallback_count == 1
        vers = eng._replica_versions["ph1"]
        for mm in ALL:
            assert ("s0", mm) in vers
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    _reference_parity(peng.records[-1], sides, ALL)


def test_redispatch_falls_back_to_glass_when_no_survivor(sides):
    def drive(side):
        eng = side.engine(redispatch=True)
        eng.inject_crash(2.05, "ph1")        # both detected at 3.0
        eng.inject_crash(2.1, "edge64x")
        rec = side.submit(eng, "s0", 0, "scene", 2.0)
        assert rec.fallback and rec.enc_tier == "glass"
        assert eng.redispatch_count == 0 and eng.fallback_count == 1
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    _reference_parity(peng.records[0], sides, ("scene",))


def test_redispatch_cascading_crash(sides):
    def drive(side):
        eng = side.engine(redispatch=True)
        eng.inject_crash(2.1, "edge64x")     # detected at 3.0
        eng.inject_crash(3.1, "ph1")         # kills the re-dispatched flight
        rec = side.submit(eng, "s0", 0, "scene", 2.0)
        assert rec.fallback and rec.enc_tier == "glass"
        assert rec.t_start >= 4.0            # ph1's missed heartbeat
        assert eng.redispatch_count == 1 and eng.fallback_count == 1
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    _reference_parity(peng.records[0], sides, ("scene",))


def test_chaos_schedule_generator_is_valid_and_reproducible():
    a = PC.chaos_schedule(11, horizon=30.0, tiers=("ph1", "edge64x"))
    assert a == PC.chaos_schedule(11, horizon=30.0,
                                  tiers=("ph1", "edge64x"))
    assert len(a) >= 2
    assert a != PC.chaos_schedule(12, horizon=30.0, tiers=("ph1", "edge64x"))
    for e in a:
        assert 0.0 < e.crash_at < 30.0
        assert e.rejoin_at is None or e.rejoin_at > e.crash_at
    with pytest.raises(ValueError):
        PC.validate_schedule([PC.FaultEvent(1.0, "ph1", 3.0),
                              PC.FaultEvent(2.0, "ph1", 4.0)])
    with pytest.raises(ValueError):
        PC.validate_schedule([PC.FaultEvent(1.0, "ph1", None),
                              PC.FaultEvent(5.0, "ph1", 6.0)])
    with pytest.raises(ValueError):
        PC.FaultEvent(2.0, "ph1", 2.0)
    # the same seed gives the reference's schedule, cycle for cycle
    for seed in range(21):
        for kw in ({"horizon": 30.0}, {"horizon": 9.5, "mean_up_s": 1.5,
                                       "mean_down_s": 0.6, "min_up_s": 0.4,
                                       "min_down_s": 0.3}):
            want = JC.chaos_schedule(seed, tiers=("ph1", "edge64x"), **kw)
            got = PC.chaos_schedule(seed, tiers=("ph1", "edge64x"), **kw)
            assert [(e.crash_at, e.tier, e.rejoin_at) for e in got] == \
                [(e.crash_at, e.tier, e.rejoin_at) for e in want]


def _chaos_eps(pkg):
    return {f"s{i}": pkg.async_episode("text_first", seed=i)
            for i in range(2)}


def test_chaos_cycles_replay_with_parity_and_staleness(sides):
    def drive(side):
        eps = _chaos_eps(side.pkg)
        chaos = PC if side.is_port else JC
        sched = chaos.chaos_schedule(
            5, horizon=side.pkg.horizon(eps), tiers=("ph1", "edge64x"),
            mean_up_s=1.5, mean_down_s=0.6, min_up_s=0.4, min_down_s=0.3)
        assert len(sched) >= 4               # several cycles land
        eng = side.engine(redispatch=True)
        eng.run_arrivals(eps, lambda sid, ev: side.payloads[ev.modality],
                         schedule=sched)
        assert eng.rejoin_count >= 2         # cycles, not one outage
        ss = eng.speculation_stats()
        assert ss["duplicate_commits"] == 0 and ss["stale_commits"] == 0
        for sid, st in eng.sessions.items():
            for m, step in st.input_step.items():
                e = eng.cache.peek(sid, m)
                assert e is not None and step - e.step <= 1
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    _observed_parity(peng.records, sides)


def test_chaos_multiple_cycles_between_two_arrivals(sides):
    def drive(side):
        chaos = PC if side.is_port else JC
        eng = side.engine()
        eng.inject_schedule([chaos.FaultEvent(1.0, "edge64x", 2.0),
                             chaos.FaultEvent(3.0, "edge64x", 4.0),
                             chaos.FaultEvent(5.0, "edge64x", 6.0)])
        rec = side.submit(eng, "s0", 0, "text", 0.5)
        assert rec.enc_tier == "edge64x" and not rec.fallback
        rec = side.submit(eng, "s0", 1, "vitals", 20.0)
        assert rec.enc_tier == "edge64x" and not rec.fallback
        assert eng.rejoin_count == 3
        assert not eng._faults["edge64x"].dead
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    _reference_parity(peng.records[-1], sides, ("text", "vitals"))
    with pytest.raises(ValueError, match="unknown tier"):
        peng.inject_schedule([PC.FaultEvent(1.0, "mars", 2.0)])
