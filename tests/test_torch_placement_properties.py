"""Property tests (Hypothesis) of the port's N-tier placement rule
(``core.offload.MultiTierPolicy``), the properties of
``tests/test_placement_properties.py``. Every example drives the port's
policy and the reference's on the same inputs: the port must make the
reference's decision, with the same candidate costs, and hold the
property itself.

  * the chosen placement never loses to all-local;
  * decisions are monotone in bandwidth and in queue depth;
  * a tier with infinite queueing delay, or an unavailable one, is never
    chosen;
  * per-submodule force pins exactly what it names;
  * a speculation policy marks a decision exactly when the reference
    does, with the same margin, and never a forced one.
"""
import math

import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="optional dev dep (requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import offload as J  # noqa: E402
from repro_torch.core import offload as P  # noqa: E402

SETTINGS = dict(max_examples=50, deadline=None)

REMOTES = ("ph1", "edge4c", "edge64x")
LOCAL = "glass"

bw_st = st.floats(min_value=1e3, max_value=1e9)
t_st = st.floats(min_value=1e-4, max_value=10.0)
q_st = st.floats(min_value=0.0, max_value=30.0)
pay_st = st.integers(min_value=1, max_value=10_000_000)


def _policies(base_enc, base_tail, bws, **kw):
    """(reference, port) policies over the same profile and links."""
    out = []
    for pkg in (J, P):
        kw2 = dict(kw)
        if "speculation" in kw2:
            kw2["speculation"] = pkg.SpeculationPolicy(*kw["speculation"])
        prof = pkg.ProfileTable(base={"enc:m": base_enc, "tail": base_tail})
        monitors = {n: pkg.HeartbeatMonitor(pkg.BandwidthTrace.static(bw))
                    for n, bw in bws.items()}
        out.append(pkg.MultiTierPolicy(
            prof, monitors, local=LOCAL,
            tier_of={LOCAL: LOCAL, **{n: n for n in bws}}, **kw2))
    return out


def _decide(pols, *a, tail=False, **kw):
    """The port's decision, after checking it is the reference's."""
    j, p = (pol.decide_tail(*a, **kw) if tail else pol.decide(*a, **kw)
            for pol in pols)
    assert (p.tier, p.speculate, p.precision) == \
        (j.tier, j.speculate, j.precision)
    assert list(p.estimates) == list(j.estimates)
    for n, e in j.estimates.items():
        assert p.estimates[n].cost == e.cost
    assert p.margin_s == j.margin_s or (math.isinf(p.margin_s)
                                        and math.isinf(j.margin_s))
    return p


@st.composite
def scenarios(draw, n_remotes=len(REMOTES)):
    remotes = REMOTES[:draw(st.integers(1, n_remotes))]
    bws = {n: draw(bw_st) for n in remotes}
    queues = {n: draw(q_st) for n in (LOCAL, *remotes)}
    return (draw(t_st), draw(t_st), bws, queues, draw(pay_st))


@given(scenarios())
@settings(**SETTINGS)
def test_chosen_placement_never_loses_to_all_local(sc):
    base_enc, base_tail, bws, queues, payload = sc
    pols = _policies(base_enc, base_tail, bws)
    d = _decide(pols, "enc:m", payload, 0.0, queues=queues)
    assert d.estimates[d.tier].cost <= d.estimates[LOCAL].cost
    assert _decide(pols, "enc:m", payload, 0.0, queues=queues).tier == d.tier


@given(scenarios(), st.floats(min_value=1.0, max_value=1e4))
@settings(**SETTINGS)
def test_offloading_monotone_in_bandwidth(sc, scale):
    base_enc, base_tail, bws, queues, payload = sc
    d_lo = _decide(_policies(base_enc, base_tail, bws),
                   "enc:m", payload, 0.0, queues=queues)
    d_hi = _decide(_policies(base_enc, base_tail,
                             {n: bw * scale for n, bw in bws.items()}),
                   "enc:m", payload, 0.0, queues=queues)
    if d_lo.tier != LOCAL:
        assert d_hi.tier != LOCAL


@given(scenarios(), st.floats(min_value=1e-3, max_value=100.0))
@settings(**SETTINGS)
def test_decision_monotone_in_queue_depth(sc, extra):
    base_enc, base_tail, bws, queues, payload = sc
    pols = _policies(base_enc, base_tail, bws)
    d = _decide(pols, "enc:m", payload, 0.0, queues=queues)
    for loser in d.estimates:
        if loser == d.tier:
            continue
        deeper = dict(queues)
        deeper[loser] = deeper.get(loser, 0.0) + extra
        assert _decide(pols, "enc:m", payload, 0.0,
                       queues=deeper).tier == d.tier
    if d.tier != LOCAL:
        worst = dict(queues)
        worst[d.tier] = max(e.cost for e in d.estimates.values()) + extra
        assert _decide(pols, "enc:m", payload, 0.0,
                       queues=worst).tier != d.tier


@given(scenarios())
@settings(**SETTINGS)
def test_infinite_queue_tier_never_chosen(sc):
    base_enc, base_tail, bws, queues, payload = sc
    pols = _policies(base_enc, base_tail, bws)
    for jammed in bws:
        q = dict(queues)
        q[jammed] = math.inf
        assert _decide(pols, "enc:m", payload, 0.0, queues=q).tier != jammed
        assert _decide(pols, payload, payload, LOCAL, 0.0, queues=q,
                       tail=True).tier != jammed


@given(scenarios())
@settings(**SETTINGS)
def test_unavailable_tier_never_chosen(sc):
    base_enc, base_tail, bws, queues, payload = sc
    pols = _policies(base_enc, base_tail, bws)
    dead = sorted(bws)[0]
    alive = [n for n in bws if n != dead]
    d = _decide(pols, "enc:m", payload, 0.0, queues=queues, available=alive)
    assert d.tier != dead and dead not in d.estimates


@given(scenarios())
@settings(**SETTINGS)
def test_tail_placement_never_loses_to_local_tail(sc):
    base_enc, base_tail, bws, queues, payload = sc
    pols = _policies(base_enc, base_tail, bws)
    for enc_tier in (LOCAL, *bws):
        d = _decide(pols, payload, payload // 2, enc_tier, 0.0,
                    queues=queues, tail=True)
        assert d.estimates[d.tier].cost <= d.estimates[LOCAL].cost


@given(scenarios())
@settings(**SETTINGS)
def test_per_submodule_force_pins_exactly_what_it_names(sc):
    base_enc, base_tail, bws, queues, payload = sc
    target = sorted(bws)[-1]
    pols = _policies(base_enc, base_tail, bws,
                     force={"enc:m": target, "tail": LOCAL},
                     speculation=(0.0, 0.0))
    d = _decide(pols, "enc:m", payload, 0.0, queues=queues)
    assert d.tier == target and not d.speculate     # forced: never races
    assert _decide(pols, payload, payload, target, 0.0, queues=queues,
                   tail=True).tier == LOCAL
    assert _decide(pols, "enc:m", payload, 0.0, queues=queues,
                   available=[]).tier == LOCAL


@given(scenarios(), st.floats(min_value=0.0, max_value=20.0),
       st.floats(min_value=0.0, max_value=5.0),
       st.floats(min_value=0.0, max_value=5.0))
@settings(**SETTINGS)
def test_speculation_marks_thin_margins_only(sc, deadline, margin, late):
    base_enc, base_tail, bws, queues, payload = sc
    pols = _policies(base_enc, base_tail, bws,
                     speculation=(deadline, margin))
    d = _decide(pols, "enc:m", payload, 0.0, queues=queues, lateness_s=late)
    assert d.margin_s == deadline - late - d.estimates[d.tier].cost
    assert d.speculate == (d.margin_s < margin)


def test_force_rejects_unknown_tier():
    for pkg in (J, P):
        with pytest.raises(ValueError):
            pkg.MultiTierPolicy(
                pkg.ProfileTable(base={"enc:m": 0.1, "tail": 0.01}),
                {"ph1": pkg.HeartbeatMonitor(pkg.BandwidthTrace.static(1e6))},
                local=LOCAL, tier_of={LOCAL: LOCAL, "ph1": "ph1"},
                force="warp9")
