"""The placement knobs of the port against the JAX reference, on the CPU.

``PlacementPolicy``'s ``glass_tier``, ``edge_tier``, ``hb_period``,
``link_latency_s``, ``int8_compute_scale`` and ``int8_bytes_scale``, the
matching arguments of ``TieredEMSServe`` and ``MultiTierPolicy``, and the
engine's ``offloaded_count``/``on_glass_count``: each set away from its
default drives both packages' engines (or policies) the same way. The
weights, payloads and tolerances are those of ``test_torch_speculation.py``.
"""
import dataclasses

import pytest

import repro.core as J
from repro.core.offload import MultiTierPolicy as JPolicy
from repro.serving.api import PlacementPolicy as JPlacement
from repro_torch import core as P
from repro_torch.core.offload import MultiTierPolicy as PPolicy
from repro_torch.serving.api import PlacementPolicy as PPlacement
from test_torch_speculation import (ALL, BASE, both,  # noqa: F401
                                    same_engines, sides)
from test_torch_tiered_runtime import _episode, _tiered

KNOBS = ("glass_tier", "edge_tier", "hb_period", "link_latency_s",
         "int8_compute_scale", "int8_bytes_scale")
INT8 = {"ph1": "int8", "edge64x": "int8"}


def _policy(pkg, cls, bw_mbps, **kw):
    trace = pkg.BandwidthTrace.static(bw_mbps * 1e6 / 8)
    mon = {"edge": pkg.HeartbeatMonitor(trace, period=1.0)}
    return cls(pkg.ProfileTable(base=dict(BASE)), mon, local="glass",
               tier_of={"glass": "glass", "edge": "edge64x"}, **kw)


def test_placement_knob_defaults_are_the_reference_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(JPlacement)}
    pf = {f.name: f.default for f in dataclasses.fields(PPlacement)}
    assert {k: pf[k] for k in KNOBS} == {k: jf[k] for k in KNOBS}
    assert {k: pf[k] for k in KNOBS} == {
        "glass_tier": "glass", "edge_tier": "edge4c", "hb_period": 1.0,
        "link_latency_s": 0.005, "int8_compute_scale": 0.5,
        "int8_bytes_scale": 0.25}


def test_joint_decision_ties_keep_fp32():
    """With compute scale 1.0 and no feature bytes, int8 buys nothing —
    the per-tier argmin must keep fp32 (no gratuitous quantization)."""
    pol = _policy(P, PPolicy, 100.0, precisions={"edge": ("fp32", "int8")},
                  int8_compute_scale=1.0)
    dec = pol.decide("enc:text", 1000, 0.0, feat_bytes=0)
    assert dec.estimates["edge"].precision == "fp32"
    assert dec.precision == "fp32"


@pytest.mark.parametrize("scales", [(0.5, 0.25), (1.0, 0.25), (0.9, 0.6),
                                    (0.2, 1.0)])
@pytest.mark.parametrize("bw_mbps", [0.5, 2.0, 100.0])
def test_joint_decision_scales_match_reference(scales, bw_mbps):
    """Every (tier, precision) estimate under the two scales equals the
    reference's, decision for decision (exact: the same float64 sums)."""
    kw = dict(precisions={"edge": ("fp32", "int8")},
              int8_compute_scale=scales[0], int8_bytes_scale=scales[1])
    jpol = _policy(J, JPolicy, bw_mbps, **kw)
    ppol = _policy(P, PPolicy, bw_mbps, **kw)
    for payload in (1000, 200_000):
        for fb in (0, 400_000):
            a = jpol.decide("enc:text", payload, 0.0, feat_bytes=fb)
            b = ppol.decide("enc:text", payload, 0.0, feat_bytes=fb)
            assert (a.tier, a.precision) == (b.tier, b.precision)
            for n in a.estimates:
                assert a.estimates[n].precision == b.estimates[n].precision
                assert a.estimates[n].cost == b.estimates[n].cost


@pytest.mark.parametrize("knobs", [
    {"hb_period": 0.5, "crash": 0.25},
    {"hb_period": 2.0, "crash": 0.25},
    {"link_latency_s": 0.05},
    {"glass_tier": "ph1", "edge_tier": "edge64x"},
], ids=["hb0.5", "hb2", "latency", "tier-keys"])
def test_tiered_runtime_knobs_match_reference(knobs, sides):
    """The legacy two-tier ``TieredEMSServe`` with a knob away from its
    default: records, clocks, link bytes and cache as the reference's."""
    knobs = dict(knobs)
    crash = knobs.pop("crash", None)

    def drive(side):
        eng = _tiered(side, bw_m=0.0, **knobs)
        if crash is not None:
            eng.inject_edge_crash(crash)
        _episode(side, eng)
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    if "hb_period" in knobs:
        assert peng.detect_at == jeng.detect_at


@pytest.mark.parametrize("scales", [(1.0, 0.25), (0.5, 1.0), (0.1, 0.1)])
def test_engine_int8_scales_match_reference(scales, sides):
    """The N-tier int8 engine with both scales set: the same placements,
    precisions and clocks as the reference."""
    def drive(side):
        eng = side.engine(precision=INT8, bandwidth=30.0,
                          int8_compute_scale=scales[0],
                          int8_bytes_scale=scales[1])
        for i, m in enumerate(ALL * 2):
            side.submit(eng, "s0", i, m, float(i))
        return eng
    jeng, peng = both(sides, drive)
    same_engines(jeng, peng)
    assert peng.policy.int8_compute_scale == scales[0]
    assert peng.policy.int8_bytes_scale == scales[1]


def test_offloaded_and_on_glass_counts_match_reference(sides):
    """Through a drive that offloads, falls back to glass after a crash
    and serves on glass: both counters equal the reference's."""
    def drive(side):
        eng = _tiered(side, bw_m=0.0)
        eng.inject_edge_crash(2.1)
        _episode(side, eng)
        side.submit(eng, "s0", 3, "vitals", 3.0)
        g = _tiered(side, force="glass")
        _episode(side, g, sid="s1")
        return eng, g
    (jeng, jg), (peng, pg) = both(sides, drive)
    for j, p in ((jeng, peng), (jg, pg)):
        assert (p.offloaded_count, p.on_glass_count) == \
            (j.offloaded_count, j.on_glass_count)
    assert peng.offloaded_count > 0 and peng.on_glass_count > 0
    assert pg.offloaded_count == 0 and pg.on_glass_count > 0
