"""Property tests (Hypothesis) for the port's fleet workload generator:
the claims of ``tests/test_fleet_properties.py`` on
``repro_torch.fleet``, plus one against the reference: for any drawn
``(rate, seed, time_scale)`` the port draws the reference's sessions,
event for event."""
import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="optional dev dep (requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

import repro.fleet as JF
from repro_torch.fleet import (diurnal_rate, diurnal_times, generate_workload,
                               merge_sessions, poisson_times)

SETTINGS = dict(max_examples=40, deadline=None)

rates = st.floats(min_value=0.2, max_value=30.0, allow_nan=False)
horizons = st.floats(min_value=0.1, max_value=20.0, allow_nan=False)
seeds = st.integers(min_value=0, max_value=2**31 - 1)


def _flatten(sessions):
    return [(s.sid, s.t_start, s.scenario,
             tuple((e.index, e.modality, e.arrival_time)
                   for e in s.events))
            for s in sessions]


@settings(**SETTINGS)
@given(rate=rates, horizon=horizons, seed=seeds,
       process=st.sampled_from(["poisson", "diurnal"]),
       time_scale=st.floats(min_value=0.01, max_value=2.0))
def test_workload_is_a_pure_function_of_its_seed(rate, horizon, seed,
                                                 process, time_scale):
    kw = dict(seed=seed, process=process, time_scale=time_scale)
    a = generate_workload(rate, horizon, **kw)
    b = generate_workload(rate, horizon, **kw)
    assert _flatten(a) == _flatten(b)


@settings(**SETTINGS)
@given(rate=rates, horizon=horizons, seed=seeds)
def test_poisson_times_sorted_inside_horizon(rate, horizon, seed):
    ts = poisson_times(rate, horizon, seed)
    assert ts == sorted(ts)
    assert all(0.0 <= t < horizon for t in ts)


@settings(**SETTINGS)
@given(base=rates, amp=st.floats(min_value=0.0, max_value=0.99),
       period=st.floats(min_value=1.0, max_value=1e5),
       phase=st.floats(min_value=-1e4, max_value=1e4),
       t=st.floats(min_value=0.0, max_value=1e5))
def test_diurnal_rate_never_escapes_envelope(base, amp, period, phase, t):
    r = diurnal_rate(t, base, amp=amp, period=period, phase=phase)
    assert base * (1 - amp) - 1e-9 <= r <= base * (1 + amp) + 1e-9


@settings(**SETTINGS)
@given(base=rates, horizon=horizons, seed=seeds,
       amp=st.floats(min_value=0.0, max_value=0.9))
def test_diurnal_times_sorted_inside_horizon(base, horizon, seed, amp):
    ts = diurnal_times(base, horizon, seed, amp=amp, period=60.0)
    assert ts == sorted(ts)
    assert all(0.0 <= t < horizon for t in ts)


@settings(**SETTINGS)
@given(rate=rates, seed=seeds,
       time_scale=st.floats(min_value=0.01, max_value=2.0))
def test_per_event_times_nonnegative_and_merged_order(rate, seed,
                                                      time_scale):
    sessions = generate_workload(rate, 5.0, seed=seed,
                                 time_scale=time_scale)
    for s in sessions:
        per_mod = {}
        for e in s.events:
            assert e.arrival_time >= 0.0
            per_mod.setdefault(e.modality, []).append(e.arrival_time)
        for ts in per_mod.values():
            assert ts == sorted(ts)
    keys = [(t, sid) for t, sid, _ in merge_sessions(sessions)]
    assert keys == sorted(keys)


@settings(**SETTINGS)
@given(rate=rates, seed=seeds,
       scale=st.floats(min_value=0.05, max_value=0.95))
def test_time_scale_is_linear_intra_session_dilation(rate, seed, scale):
    ref = generate_workload(rate, 5.0, seed=seed, time_scale=1.0)
    got = generate_workload(rate, 5.0, seed=seed, time_scale=scale)
    assert len(ref) == len(got)
    for s1, s2 in zip(ref, got):
        assert s2.t_start == s1.t_start
        assert [e.modality for e in s2.events] == \
            [e.modality for e in s1.events]
        for e1, e2 in zip(s1.events, s2.events):
            assert e2.arrival_time == pytest.approx(
                scale * e1.arrival_time, rel=1e-9, abs=1e-12)


@settings(**SETTINGS)
@given(rate=rates, seed=seeds,
       process=st.sampled_from(["poisson", "diurnal"]),
       time_scale=st.floats(min_value=0.01, max_value=2.0))
def test_workload_equals_reference(rate, seed, process, time_scale):
    kw = dict(seed=seed, process=process, time_scale=time_scale)
    assert _flatten(generate_workload(rate, 5.0, **kw)) == \
        _flatten(JF.generate_workload(rate, 5.0, **kw))
