"""The port's ``TieredEMSServe`` against the JAX reference, on the CPU:
the tests of ``tests/test_tiered_runtime.py`` — every placement (adaptive,
forced, the 81 per-submodule assignments over three tiers) against the
monolithic forward, crash detection and failover, transport byte
accounting, contention-aware spreading, the legacy two-tier surface and
the wall-clock driver — each driven through both packages.

The weights, payloads and tolerances are those of
``test_torch_speculation.py``; where the reference asserts atol 0 among
placements, the port's own runs are held bit for bit to each other and
to its own monolithic ``full``, and to the reference within 1e-5.
"""
import itertools

import pytest
import torch

from repro.serving.tiered_runtime import TieredEMSServe as JTiered
from repro.serving.transport import payload_nbytes as jax_nbytes
from repro_torch.core.offload import BandwidthTrace, ProfileTable
from repro_torch.obs import Metrics
from repro_torch.serving.event_loop import WallClockDriver
from repro_torch.serving.stream_engine import StreamingEMSServe
from repro_torch.serving.tiered_runtime import TieredEMSServe, TierHost
from repro_torch.serving.transport import TransportChannel, payload_nbytes
from test_torch_speculation import (ALL, BASE, FP32_ATOL,  # noqa: F401
                                    _reference_parity, both, same_engines,
                                    sides)


def _tiered(side, *, bw_m=0.0, trace=None, profile=None, **kw):
    pkg = side.pkg
    kw.setdefault("share_encoders", True)
    cls = TieredEMSServe if side.is_port else JTiered
    if side.is_port:
        kw["device"] = "cpu"
    return cls(side.splits, side.params,
               profile=profile or pkg.ProfileTable(base=dict(BASE)),
               trace=trace or pkg.BandwidthTrace.static(
                   pkg.nlos_bandwidth(bw_m)), **kw)


def _episode(side, eng, sid="s0"):
    return [side.submit(eng, sid, i, m, float(i)) for i, m in enumerate(ALL)]


@pytest.mark.parametrize("force", [None, "glass", "edge"],
                         ids=["adaptive", "all-glass", "all-edge"])
def test_every_placement_matches_monolithic_full(force, sides):
    def drive(side):
        eng = _tiered(side, force=force)
        for rec in _episode(side, eng):
            assert rec.outputs is not None
            if force is not None:
                assert rec.tier == force
        assert eng.sessions["s0"].records[-1].kind == "final"
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    for i, rec in enumerate(peng.records):
        _reference_parity(rec, sides, ALL[:i + 1])


def test_parity_after_midepisode_edge_crash(sides):
    def drive(side):
        eng = _tiered(side, bw_m=0.0)
        eng.inject_edge_crash(2.1)
        recs = _episode(side, eng)
        assert [r.tier for r in recs] == ["edge", "edge", "glass"]
        assert recs[2].fallback and eng.fallback_count == 1
        assert eng.edge_known_dead
        assert eng.detect_at == 3.0
        assert recs[2].t_start >= eng.detect_at
        rec = side.submit(eng, "s0", 3, "vitals", 3.0)
        assert rec.tier == "glass" and not rec.fallback
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    for i, rec in enumerate(peng.records):
        _reference_parity(rec, sides, ALL[:min(i, 2) + 1])


def test_crash_before_detection_window_pays_timeout(sides):
    def drive(side):
        eng = _tiered(side, bw_m=0.0)                  # 1 s heartbeats
        eng.inject_edge_crash(0.25)
        rec = side.submit(eng, "s0", 0, "text", 0.5)
        assert rec.tier == "glass" and rec.fallback
        assert rec.detect_s == pytest.approx(0.5)      # stalled 0.5 -> 1.0
        assert rec.t_start >= 1.0
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    _reference_parity(peng.records[0], sides, ("text",))


def test_crash_during_downlink_transfer_loses_result(sides):
    def drive(side):
        if side.is_port:
            # the port's link latency is a constant: set the fabric's
            # before any channel exists
            eng = _tiered(side, bw_m=0.0)
            eng.fabric.latency_s = 0.5
        else:
            eng = _tiered(side, bw_m=0.0, link_latency_s=0.5)
        eng.inject_edge_crash(0.9)        # between compute and delivery
        rec = side.submit(eng, "s0", 0, "text", 0.0)
        assert rec.fallback and rec.tier == "glass"
        assert eng.downlink.msgs_sent == 0           # nothing arrived
        assert eng.cache.peek("s0", "text").tier == "glass"
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    _reference_parity(peng.records[0], sides, ("text",))


def test_adaptive_beats_forced_placements_on_the_clock(sides):
    def drive(side):
        pkg = side.pkg
        eps = {f"s{i}": pkg.async_episode("text_first", seed=i, n_vitals=3,
                                          n_scene=2) for i in range(2)}

        def total(trace, force):
            eng = _tiered(side, trace=trace, force=force)
            eng.run_arrivals(eps, lambda sid, ev: side.payloads[ev.modality])
            return eng.total_latency_s()

        near = pkg.BandwidthTrace.static(pkg.nlos_bandwidth(0.0))
        far = pkg.BandwidthTrace.static(pkg.nlos_bandwidth(60.0))
        out = {k: total(tr, f) for k, (tr, f) in {
            "near": (near, None), "near_glass": (near, "glass"),
            "far": (far, None), "far_edge": (far, "edge")}.items()}
        assert out["near"] < out["near_glass"]
        assert out["far"] <= out["far_edge"] * 1.05
        return out
    jout, pout = both(sides, drive)
    for k in jout:
        assert pout[k] == pytest.approx(jout[k], abs=1e-8)


def test_offload_ships_bytes_and_fallback_does_not(sides):
    def drive(side):
        eng = _tiered(side, bw_m=0.0)
        side.submit(eng, "s0", 0, "text", 0.0)
        up0, down0 = eng.uplink.msgs_sent, eng.downlink.msgs_sent
        assert up0 == 1 and down0 == 1
        feat = eng.cache.peek("s0", "text").feature
        outs = eng.sessions["s0"].records[0].outputs
        nbytes = payload_nbytes if side.is_port else jax_nbytes
        assert eng.downlink.bytes_sent == (nbytes(feat) + nbytes(outs)
                                           + eng.downlink.overhead_bytes)
        eng.inject_edge_crash(0.9)
        side.submit(eng, "s0", 1, "vitals", 0.95)
        assert eng.sessions["s0"].records[-1].fallback
        assert eng.uplink.msgs_sent == up0 + 1        # a wasted dispatch
        assert eng.downlink.msgs_sent == down0        # nothing came back
        return eng
    same_engines(*both(sides, drive))


def test_edge_replica_sync_only_ships_stale_features(sides):
    def drive(side):
        eng = _tiered(side, bw_m=0.0)
        _episode(side, eng)
        b0 = eng.uplink.bytes_sent
        side.submit(eng, "s0", 3, "vitals", 4.0)
        vitals_declared = side.splits["vitals"].module.payload_bytes["vitals"]
        assert eng.uplink.bytes_sent - b0 == (vitals_declared
                                              + eng.uplink.overhead_bytes)
        return eng
    same_engines(*both(sides, drive))


def test_exhaustive_per_submodule_placements_match_full_atol0(sides):
    """Every 3^4 (enc:text, enc:vitals, enc:scene, tail) assignment lands
    on the forced hosts; the port's final output equals its own
    monolithic ``full`` bit for bit, every intermediate row is bitwise
    equal across the 81 assignments, and the timelines and link bytes
    equal the reference's assignment for assignment."""
    jside, pside, _ = sides
    tiers = ("glass", "ph1", "edge64x")
    submods = pside.splits["text+vitals+scene"].submodules()
    assert submods == ("enc:text", "enc:vitals", "enc:scene", "tail")
    assert submods == jside.splits["text+vitals+scene"].submodules()
    full = pside.splits["text+vitals+scene"]
    with torch.inference_mode():
        want = full.full(pside.params["text+vitals+scene"],
                         {m: torch.as_tensor(v)
                          for m, v in pside.payloads.items()})
    ref_rows = None
    for combo in itertools.product(tiers, repeat=len(submods)):
        force = dict(zip(submods, combo))

        def drive(side):
            eng = _tiered(side, tiers=tiers, force=force,
                          trace=side.pkg.BandwidthTrace.static(
                              side.pkg.nlos_bandwidth(5.0)))
            for rec in _episode(side, eng):
                assert rec.enc_tier == force[f"enc:{rec.modality}"], combo
                assert rec.outputs is not None
                assert rec.tail_tier == force["tail"], combo
            return eng
        jeng, peng = both(sides, drive)
        same_engines(jeng, peng)
        final = peng.sessions["s0"].records[-1]
        assert final.kind == "final"
        for k in want:
            assert torch.equal(final.outputs[k], want[k]), combo
        rows = [r.outputs for r in peng.records]
        if ref_rows is None:
            ref_rows = rows
        else:
            for got, ref in zip(rows, ref_rows):
                for k in ref:
                    assert torch.equal(got[k], ref[k]), combo
    _reference_parity(final, sides, ALL)


def test_contention_aware_decisions_spread_sessions(sides):
    def drive(side):
        profile = side.pkg.ProfileTable(
            base=dict(BASE), factors={"glass": 40.0, "ph1": 1.2,
                                      "edge4c": 2.7, "edge64x": 1.0})

        def run(contention_aware):
            eng = _tiered(side, trace=side.pkg.BandwidthTrace.static(1e9),
                          profile=profile, tiers=("glass", "ph1", "edge64x"),
                          contention_aware=contention_aware)
            for i in range(4):
                side.submit(eng, f"s{i}", 0, "text", 0.0)
            return eng

        aware, blind = run(True), run(False)
        assert aware.place_counts["ph1"] > 0 \
            and aware.place_counts["edge64x"] > 0
        assert blind.place_counts["edge64x"] == 4
        assert aware.makespan_s() <= blind.makespan_s()
        return aware, blind
    (ja, jb), (pa, pb) = both(sides, drive)
    same_engines(ja, pa)
    same_engines(jb, pb)


def test_legacy_two_tier_surface_is_unchanged(sides):
    def drive(side):
        eng = _tiered(side, bw_m=0.0)
        assert not eng.contention_aware and not eng.tail_placement
        assert eng.edge.name == "edge" and eng.glass.name == "glass"
        assert eng.edge.tier == "edge4c"
        eng.inject_edge_crash(1.5)
        assert eng.crash_at == 1.5 and eng.detect_at == 2.0
        assert not eng.edge_known_dead
        side.submit(eng, "s0", 0, "text", 2.5)
        assert eng.edge_known_dead
        return eng
    same_engines(*both(sides, drive))


def test_transport_in_order_delivery_under_bandwidth_dip():
    tr = BandwidthTrace([(0.0, 1000.0), (1.0, 10.0), (2.0, 1000.0)])
    ch = TransportChannel(tr, latency_s=0.0, overhead_bytes=0)
    slow = ch.send(100, 1.0)          # 10 s of serialisation at 10 B/s
    fast = ch.send(100, 2.1)          # 0.1 s on its own
    assert slow.t_deliver == pytest.approx(11.0)
    assert fast.t_deliver >= slow.t_deliver
    assert fast.queued_s > 0
    assert ch.bytes_sent == 200 and ch.msgs_sent == 2


def test_payload_nbytes_counts_tree_leaves():
    tree = {"x": torch.zeros((2, 3), dtype=torch.float32),
            "len": torch.zeros((2,), dtype=torch.int32), "scalar": 1.5}
    assert payload_nbytes(tree) == 2 * 3 * 4 + 2 * 4 + 8


def test_tier_host_occupies_serially_and_releases_the_latest():
    host = TierHost("edge", "edge4c", ProfileTable(base=dict(BASE)))
    assert host.occupy(1.0, 0.0) == (0.0, 1.0)
    s1, d1 = host.occupy(1.0, 0.5)      # arrives while busy -> queues
    assert (s1, d1) == (1.0, 2.0)
    assert host.busy_s == pytest.approx(2.0)
    host.release(0.0, 1.0, 0.5)         # not the latest booking: no-op
    assert (host.free_at, host.busy_s) == (2.0, pytest.approx(2.0))
    host.release(s1, d1, 1.25)          # cancelled at 1.25
    assert host.free_at == 1.25 and host.busy_s == pytest.approx(1.25)


class FakeClock:
    """Deterministic wall clock: sleep() advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += max(dt, 1e-4)


def test_wall_clock_driver_fires_deadline_flush_in_a_lull(sides):
    _, pside, _ = sides
    clk = FakeClock()
    eng = StreamingEMSServe(pside.splits, pside.params, share_encoders=True,
                            deadline_s=0.5, time_fn=clk, device="cpu")
    eps = {"s0": [pside.pkg.Event(0, "text", 0.0),
                  pside.pkg.Event(1, "vitals", 0.1)]}
    drv = WallClockDriver(eng, clock=clk, sleep_fn=clk.sleep,
                          poll_interval_s=0.05)
    stats = drv.run(eps, lambda sid, ev: pside.payloads[ev.modality])
    assert stats.arrivals == 2
    assert stats.flushes_fired >= 1 and eng.flushes_total == 1
    pred = eng.sessions["s0"].predictions[-1]
    assert pred.modalities == ("text", "vitals")
    _reference_parity(pred, sides, ("text", "vitals"))
    assert isinstance(eng.metrics, Metrics)


def test_wall_clock_driver_paces_tiered_runtime(sides):
    def drive(side):
        eps = {"s0": [side.pkg.Event(i, m, float(i))
                      for i, m in enumerate(ALL)]}
        eng = _tiered(side, bw_m=5.0)
        if side.is_port:
            clk = FakeClock()
            WallClockDriver(eng, clock=clk, sleep_fn=clk.sleep,
                            speed=10.0).run(
                eps, lambda s, ev: side.payloads[ev.modality])
        else:
            eng.run_arrivals(eps, lambda s, ev: side.payloads[ev.modality])
        return eng
    jeng, peng = both(sides, drive)
    assert len(peng.records) == 3
    same_engines(jeng, peng)
