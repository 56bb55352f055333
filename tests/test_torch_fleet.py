"""The port's fleet (``repro_torch.fleet``) against the JAX reference, on
the CPU at the tiny config.

The first part mirrors every case of ``tests/test_fleet.py`` on the
port. The second holds the port to the reference on the same inputs:

  * workloads, router homes and spills, admission decisions, the
    sharding specs of the EMSNet tree and the placement report: equal;
  * ``RegionSim`` under a step clock (1 ms per ``time_fn()`` call, a
    fresh clock per side, passed through ``engine_kw``): routes, flush
    log, TTFP, report and the merged Prometheus text equal, finals
    within 1e-5 (float32 matmuls of XLA and of PyTorch round
    differently); shed-all: ``t_emit`` equal (the glass clock reads the
    ``ProfileTable``), partials within 1e-5, and the streamed trace
    audits clean. A 50 ms step makes every flush cost 50 ms of fleet
    time, so flushes coalesce, the router spills and the admission
    controller sheds part of the load: the same equalities hold.

Weights are drawn once by the JAX initialiser and carried across with
``convert.from_jax_numpy``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.core as J
import repro.fleet as JF
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.emsnet import tiny as jax_tiny
from repro.distributed.sharding import Policy as JPolicy
from repro.distributed.sharding import abstract_mesh
from repro.models import transformer as JT
from repro_torch.configs.emsnet import tiny
from repro_torch.convert import from_jax_numpy
from repro_torch.core import ProfileTable, emsnet_zoo, split
from repro_torch.distributed.sharding import Policy
from repro_torch.fleet import (AdmissionController, AdmissionPolicy, AdmitAll,
                               ConsistentHashRouter, FleetMesh, RegionSim,
                               diurnal_rate, diurnal_times, fleet_mesh,
                               generate_workload, merge_sessions,
                               place_fleet_params, poisson_times)
from repro_torch.obs import StreamingTracer, audit_file
from repro_torch.serving.api import build_engine
from repro_torch.training import tree as T

# the fixed batch bucket used on BOTH sides of every comparison, as in
# the reference's test: a session's row meets the same padded shape
# whatever else coalesced around it
ENGINE_KW = dict(batch_bucket_min=2, max_coalesce=2)
GLASS_BASE = {"enc:text": 0.08, "enc:vitals": 0.01, "enc:scene": 0.05,
              "tail": 0.005, "full": 0.15}
GLASS_PROFILE = ProfileTable(base=dict(GLASS_BASE))
ATOL = 1e-5


class StepClock:
    """``time_fn`` that advances ``step`` seconds on every call."""

    def __init__(self, step=1e-3):
        self.n, self.step = 0, step

    def __call__(self):
        self.n += 1
        return self.n * self.step


# ------------------------------------------------------------------ fixtures

@pytest.fixture(scope="module")
def fleet_models():
    cfg = tiny()
    zoo = emsnet_zoo(cfg)
    splits = {k: split(m) for k, m in zoo.items()}
    jzoo = J.emsnet_zoo(jax_tiny())
    jshared = jzoo["text+vitals+scene"].init_fn(jax.random.PRNGKey(0))
    shared = from_jax_numpy(jax.device_get(jshared), "cpu")
    placed, report = place_fleet_params({k: shared for k in zoo},
                                        fleet_mesh(device="cpu"))
    rng = np.random.default_rng(0)
    payloads = {
        "text": rng.integers(1, cfg.vocab_size, (1, 11)).astype(np.int32),
        "vitals": rng.normal(size=(1, 5, cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }
    jsplits = {k: J.split(m) for k, m in jzoo.items()}
    jplaced, jreport = JF.place_fleet_params({k: jshared for k in jzoo},
                                             JF.fleet_mesh())
    jpayloads = {m: jnp.asarray(x) for m, x in payloads.items()}
    return dict(cfg=cfg, splits=splits, shared=shared, placed=placed,
                report=report, payloads=payloads, jsplits=jsplits,
                jshared=jshared, jplaced=jplaced, jreport=jreport,
                jpayloads=jpayloads)


def _flatten(sessions):
    return [(s.sid, s.t_start, s.scenario,
             tuple((e.index, e.modality, e.arrival_time)
                   for e in s.events))
            for s in sessions]


# ------------------------------------------------------------------ workload

def test_workload_seeded_determinism():
    a = generate_workload(5.0, 3.0, seed=7)
    b = generate_workload(5.0, 3.0, seed=7)
    assert _flatten(a) == _flatten(b)
    c = generate_workload(5.0, 3.0, seed=8)
    assert _flatten(a) != _flatten(c)


def test_poisson_empirical_rate_and_bounds():
    ts = poisson_times(20.0, 200.0, seed=1)
    assert ts == sorted(ts)
    assert all(0.0 <= t < 200.0 for t in ts)
    assert len(ts) / 200.0 == pytest.approx(20.0, rel=0.15)


def test_poisson_validation():
    with pytest.raises(ValueError, match="rate"):
        poisson_times(0.0, 10.0)
    assert poisson_times(5.0, 0.0) == []
    assert poisson_times(5.0, -1.0) == []


def test_diurnal_rate_envelope():
    base, amp = 10.0, 0.6
    vals = [diurnal_rate(t, base, amp=amp, period=60.0)
            for t in np.linspace(0.0, 120.0, 97)]
    assert min(vals) >= base * (1 - amp) - 1e-9
    assert max(vals) <= base * (1 + amp) + 1e-9
    assert max(vals) == pytest.approx(base * (1 + amp), rel=1e-3)
    with pytest.raises(ValueError, match="amp"):
        diurnal_rate(0.0, base, amp=1.0)


def test_diurnal_times_rate_and_validation():
    ts = diurnal_times(20.0, 120.0, seed=2, amp=0.6, period=60.0)
    assert ts == sorted(ts)
    assert all(0.0 <= t < 120.0 for t in ts)
    assert len(ts) / 120.0 == pytest.approx(20.0, rel=0.25)
    with pytest.raises(ValueError, match="base_rate"):
        diurnal_times(-1.0, 10.0)
    with pytest.raises(ValueError, match="amp"):
        diurnal_times(10.0, 10.0, amp=1.5)
    with pytest.raises(ValueError, match="process"):
        generate_workload(1.0, 1.0, process="weekly")


def test_time_scale_compresses_sessions_only():
    w1 = generate_workload(2.0, 5.0, seed=3, time_scale=1.0)
    w2 = generate_workload(2.0, 5.0, seed=3, time_scale=0.5)
    assert len(w1) == len(w2) > 0
    for s1, s2 in zip(w1, w2):
        assert s2.t_start == s1.t_start
        assert s2.scenario == s1.scenario
        assert len(s2.events) == len(s1.events)
        for e1, e2 in zip(s1.events, s2.events):
            assert e2.modality == e1.modality
            assert e2.arrival_time == pytest.approx(
                0.5 * e1.arrival_time, abs=1e-12)
    with pytest.raises(ValueError, match="time_scale"):
        generate_workload(1.0, 1.0, time_scale=0.0)


def test_merge_sessions_global_order():
    sessions = generate_workload(4.0, 4.0, seed=5)
    arrivals = merge_sessions(sessions)
    assert len(arrivals) == sum(len(s.events) for s in sessions)
    keys = [(t, sid) for t, sid, _ in arrivals]
    assert keys == sorted(keys)
    s = sessions[0]
    for e_rel, e_abs in zip(s.events, s.absolute_events()):
        assert e_abs.arrival_time == s.t_start + e_rel.arrival_time


@pytest.mark.parametrize("process", ["poisson", "diurnal"])
@pytest.mark.parametrize("rate,horizon,seed,time_scale", [
    (3.0, 2.0, 0, 0.2), (5.0, 3.0, 7, 1.0), (20.0, 4.0, 11, 0.01),
    (0.7, 30.0, 3, 2.0)])
def test_workload_equals_reference(process, rate, horizon, seed, time_scale):
    kw = dict(seed=seed, process=process, time_scale=time_scale, period=7.0)
    got = _flatten(generate_workload(rate, horizon, **kw))
    want = _flatten(JF.generate_workload(rate, horizon, **kw))
    assert got == want and len(got) > 0


# ------------------------------------------------------------------- router

def test_router_ring_stability_on_resize():
    sids = [f"s{i}" for i in range(400)]
    r4 = ConsistentHashRouter(4)
    r5 = ConsistentHashRouter(5)
    assert all(0 <= r4.home(s) < 4 for s in sids)
    assert [r4.home(s) for s in sids] == \
        [ConsistentHashRouter(4).home(s) for s in sids]
    moved = sum(r4.home(s) != r5.home(s) for s in sids) / len(sids)
    assert 0.0 < moved < 0.45


def test_router_least_loaded_spill():
    r = ConsistentHashRouter(2, spill_s=0.05)
    sid = next(s for s in (f"s{i}" for i in range(100)) if r.home(s) == 0)
    assert r.route(sid) == 0
    assert r.route(sid, loads=[0.0, 0.0]) == 0
    assert r.spills == 0
    assert r.route(sid, loads=[1.0, 0.0]) == 1
    assert r.spills == 1
    assert r.route(sid, loads=[0.04, 0.0]) == 0
    assert r.spills == 1
    with pytest.raises(ValueError, match="loads"):
        r.route(sid, loads=[0.0])
    with pytest.raises(ValueError, match="n_replicas"):
        ConsistentHashRouter(0)


@pytest.mark.parametrize("n", range(1, 9))
def test_router_homes_equal_reference(n):
    sids = [f"f{i}" for i in range(1000)]
    assert [ConsistentHashRouter(n).home(s) for s in sids] == \
        [JF.ConsistentHashRouter(n).home(s) for s in sids]
    assert [ConsistentHashRouter(n, seed=3, vnodes=16).home(s)
            for s in sids] == \
        [JF.ConsistentHashRouter(n, seed=3, vnodes=16).home(s) for s in sids]


def test_router_routes_and_spills_equal_reference():
    rng = np.random.default_rng(4)
    ours, ref = ConsistentHashRouter(4), JF.ConsistentHashRouter(4)
    for i in range(500):
        loads = list(rng.exponential(0.05, 4))
        assert ours.route(f"s{i}", loads) == ref.route(f"s{i}", loads)
    assert ours.spills == ref.spills > 0


# ---------------------------------------------------------------- admission

def test_admission_policy_validation():
    with pytest.raises(ValueError, match="deadline_s"):
        AdmissionPolicy(deadline_s=0.0)
    with pytest.raises(ValueError, match="hysteresis"):
        AdmissionPolicy(deadline_s=1.0, enter_frac=0.5, exit_frac=0.5)
    with pytest.raises(ValueError, match="hysteresis"):
        AdmissionPolicy(deadline_s=1.0, enter_frac=1.0, exit_frac=0.0)


def test_admission_hysteresis_and_burst_recovery():
    c = AdmissionController(
        AdmissionPolicy(deadline_s=1.0, enter_frac=1.0, exit_frac=0.5), 2)
    assert c.admit(0, 0.0, 0.2)
    assert not c.admit(0, 1.0, 1.5)
    assert not c.admit(0, 2.0, 0.7)
    assert c.admit(0, 3.0, 0.4)
    assert c.transitions == [(1.0, 0, "enter"), (3.0, 0, "exit")]
    assert c.admit(1, 4.0, 0.9)
    assert c.stats() == {"admitted": 3, "shed": 2, "transitions": 2,
                         "shedding_now": 0}
    with pytest.raises(ValueError, match="n_replicas"):
        AdmissionController(AdmissionPolicy(deadline_s=1.0), 0)


def test_admission_queue_cap():
    c = AdmissionController(
        AdmissionPolicy(deadline_s=10.0, max_queue=2), 1)
    assert c.admit(0, 0.0, 0.0, queue_depth=2)
    assert not c.admit(0, 1.0, 0.0, queue_depth=3)
    assert not c.admit(0, 2.0, 0.0, queue_depth=3)
    assert c.admit(0, 3.0, 0.0, queue_depth=0)
    assert [k for _, _, k in c.transitions] == ["enter", "exit"]


def test_admit_all_never_sheds():
    c = AdmitAll()
    assert all(c.admit(0, float(i), 1e9) for i in range(5))
    assert c.stats() == {"admitted": 5, "shed": 0, "transitions": 0,
                         "shedding_now": 0}


def test_admission_equals_reference():
    rng = np.random.default_rng(9)
    pol = dict(deadline_s=0.2, enter_frac=0.9, exit_frac=0.4, max_queue=6)
    ours = AdmissionController(AdmissionPolicy(**pol), 3)
    ref = JF.AdmissionController(JF.AdmissionPolicy(**pol), 3)
    for i in range(400):
        r, wait = int(rng.integers(0, 3)), float(rng.exponential(0.15))
        depth = int(rng.integers(0, 9))
        assert ours.admit(r, 0.01 * i, wait, depth) == \
            ref.admit(r, 0.01 * i, wait, depth)
    assert ours.transitions == ref.transitions
    assert len(ours.transitions) > 4
    assert ours.stats() == ref.stats()
    msgs = []
    for cls in (AdmissionPolicy, JF.AdmissionPolicy):
        with pytest.raises(ValueError) as e:
            cls(deadline_s=1.0, exit_frac=1.0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------- placement

def test_place_fleet_params_identity_and_report(fleet_models):
    shared, placed, report = (fleet_models[k] for k in
                              ("shared", "placed", "report"))
    assert len({id(v) for v in placed.values()}) == 1
    ref = T.leaves(shared)
    got = T.leaves(next(iter(placed.values())))
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert report["devices"] >= 1
    assert report["axis_sizes"]["model"] == 1
    assert report["param_leaves"] == (report["sharded_leaves"]
                                      + report["replicated_leaves"])
    assert report["param_leaves"] == len(ref)
    assert report["param_bytes"] == sum(
        x.numel() * x.element_size() for x in ref)


def test_placement_report_equals_reference(fleet_models):
    assert fleet_models["report"] == fleet_models["jreport"]


def test_fleet_mesh_needs_a_card_unless_asked_for_cpu():
    mesh = fleet_mesh(4, device="cpu")
    assert mesh.devices.shape == (1, 1)
    assert mesh.axis_names == ("data", "model")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet_mesh()


def test_placement_refuses_a_model_axis(fleet_models):
    grid = np.empty((1, 2), dtype=object)
    grid[0, 0] = grid[0, 1] = torch.device("cpu")
    with pytest.raises(ValueError, match="model=2"):
        place_fleet_params({"m": fleet_models["shared"]}, FleetMesh(grid))


def _specs(ours, ref, tree):
    """(key path, spec) of every leaf: the port's specs walked with
    ``tree``'s paths, the reference's flattened with JAX's."""
    def at(t, path):
        for k in path:
            t = t[k]
        return t
    got = [("".join(f"[{k!r}]" for k in path), at(ours, path))
           for path, _ in T.paths(tree)]
    want = [(jax.tree_util.keystr(p), tuple(s)) for p, s in
            jax.tree_util.tree_flatten_with_path(
                ref, is_leaf=lambda x: isinstance(x, JP))[0]]
    return got, want


@pytest.mark.parametrize("strategy", ["2d", "fsdp"])
def test_param_pspecs_equal_reference(fleet_models, strategy):
    mesh, jmesh = fleet_mesh(device="cpu"), JF.fleet_mesh()
    got, want = _specs(
        Policy(None, mesh, strategy=strategy).param_pspecs(
            fleet_models["shared"]),
        JPolicy(None, jmesh, strategy=strategy).param_pspecs(
            fleet_models["jshared"]),
        fleet_models["shared"])
    assert got == want
    if strategy == "2d":    # the four wo.w and the two embeddings
        assert sum(any(a is not None for a in s) for _, s in got) == 6


@pytest.mark.parametrize("arch", JARCHS)
def test_param_pspecs_equal_reference_on_the_llm_zoo(arch):
    """Every branch of the spec rules, on the reference's parameter
    shapes of each architecture (reduced), over meshes that split
    'data' and 'model', tuned or not, in both strategies."""
    cfg = jreduced(jget_config(arch), d_model=64)
    shapes = jax.eval_shape(lambda k: JT.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    sharded = 0
    for grid, tuned, strategy in itertools.product(
            [(4, 2), (2, 4), (1, 1)], [False, True], ["2d", "fsdp"]):
        kw = dict(tuned=tuned, strategy=strategy)
        mesh = FleetMesh(np.empty(grid, dtype=object))
        got, want = _specs(
            Policy(cfg, mesh, **kw).param_pspecs(shapes),
            JPolicy(cfg, abstract_mesh(grid, ("data", "model")),
                    **kw).param_pspecs(shapes), shapes)
        assert got == want, (grid, tuned, strategy)
        sharded += sum(any(a is not None for a in s) for _, s in got)
    assert sharded > 0


# --------------------------------------------------------------- region sim

SHED_ALL = 1e-4      # a deadline far below the service prior: all shed


def _run_pair(fm, sessions, *, step=1e-3, deadline=None):
    """The same drive through both packages' RegionSim, each with its own
    step clock; with ``deadline``, admission control at that deadline and
    the glass profile for what it sheds."""
    kw, jkw = {}, {}
    if deadline is not None:
        kw = dict(profile=GLASS_PROFILE, admission=AdmissionController(
            AdmissionPolicy(deadline_s=deadline), 2))
        jkw = dict(profile=J.ProfileTable(base=dict(GLASS_BASE)),
                   admission=JF.AdmissionController(
                       JF.AdmissionPolicy(deadline_s=deadline), 2))
    ours = RegionSim(fm["splits"], fm["placed"], n_replicas=2,
                     engine_kw=dict(ENGINE_KW, time_fn=StepClock(step)),
                     device="cpu", **kw)
    ref = JF.RegionSim(fm["jsplits"], fm["jplaced"], n_replicas=2,
                       engine_kw=dict(ENGINE_KW, time_fn=StepClock(step)),
                       **jkw)
    ours.run(sessions, lambda sid, ev: fm["payloads"][ev.modality])
    ref.run(sessions, lambda sid, ev: fm["jpayloads"][ev.modality])
    return ours, ref


def _close(got, want, atol=ATOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol, rtol=0, err_msg=k)


def _same_sims(ours, ref, sessions):
    """Routes, flush log, TTFP and time-to-final, report and the merged
    Prometheus text equal; finals and glass partials within ATOL, the
    glass records' times equal. Every line of the Prometheus text is
    compared: neither registry counts compiles, so no line is left out."""
    assert ours.route_of == ref.route_of
    assert ours.degraded == ref.degraded
    assert ours.flush_log == ref.flush_log
    assert ours.ttfp == ref.ttfp and ours.ttfinal == ref.ttfinal
    assert ours.report() == ref.report()
    assert ours.fleet_metrics().to_prometheus() == \
        ref.fleet_metrics().to_prometheus()
    for s in sessions:
        got, want = ours.final_outputs(s.sid), ref.final_outputs(s.sid)
        assert (got is None) == (want is None)
        if got is not None:
            _close(got, want)
    if ref.glass is None:
        assert ours.glass is None
        return
    assert len(ours.glass.records) == len(ref.glass.records)
    for a, b in zip(ours.glass.records, ref.glass.records):
        assert (a.sid, a.index, a.modality, a.model, a.t_arrival,
                a.t_emit, a.kind, a.degraded) == \
            (b.sid, b.index, b.modality, b.model, b.t_arrival, b.t_emit,
             b.kind, b.degraded)
        assert (a.outputs is None) == (b.outputs is None)
        if a.outputs is not None:
            _close(a.outputs, b.outputs)
    assert ours.glass.ttfp == ref.glass.ttfp


def test_region_sim_conservation_and_parity(fleet_models):
    fm = fleet_models
    splits, placed, payloads = fm["splits"], fm["placed"], fm["payloads"]
    sessions = generate_workload(3.0, 2.0, seed=0, time_scale=0.2)
    assert len(sessions) >= 2
    sim = RegionSim(splits, placed, n_replicas=2,
                    engine_kw=dict(ENGINE_KW), device="cpu")
    rep = sim.run(sessions, lambda sid, ev: payloads[ev.modality])

    n = len(sessions)
    assert rep["sessions_offered"] == n
    assert rep["sessions_admitted"] == n and rep["sessions_shed"] == 0
    assert rep["sessions_finalized"] == n
    assert rep["events_admitted"] == sum(len(s.events) for s in sessions)
    assert sim.makespan() >= sessions[-1].t_start
    assert len(sim.ttfp) == n and len(sim.ttfinal) == n
    assert all(sim.ttfp[s.sid] <= sim.ttfinal[s.sid] for s in sessions)

    # every admitted session's finals equal the port's own per-event
    # engine built with the SAME fixed batch bucket, bit for bit
    for s in sessions:
        ref = build_engine(splits, placed, "batch+stream",
                           share_encoders=True, deadline_s=None,
                           device="cpu", **ENGINE_KW)
        preds = []
        for ev in s.events:
            ref.submit(s.sid, ev, payloads[ev.modality])
            preds.extend(ref.flush().predictions)
        want = next(p.outputs for p in reversed(preds)
                    if p.kind == "final")
        got = sim.final_outputs(s.sid)
        assert got is not None and set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k

    mx = sim.fleet_metrics()
    assert mx.get("fleet.sessions_offered") == n
    assert mx.get("fleet.flushes") == len(sim.flush_log)
    prom = mx.to_prometheus()
    assert "# TYPE emsserve_fleet_sessions_offered counter" in prom
    assert "# TYPE emsserve_fleet_ttfp_s summary" in prom
    assert f"emsserve_fleet_ttfp_s_count {n}" in prom


@pytest.mark.parametrize("step", [1e-3, 5e-2], ids=["1ms", "50ms"])
def test_region_sim_equals_reference_under_a_step_clock(fleet_models, step):
    sessions = generate_workload(3.0, 1.5, seed=0, time_scale=0.2)
    assert len(sessions) == 8
    ours, ref = _run_pair(fleet_models, sessions, step=step)
    _same_sims(ours, ref, sessions)
    assert ours.report()["sessions_finalized"] == len(sessions)
    if step > 1e-3:     # the drive coalesces and spills
        assert max(n for *_, n in ours.flush_log) > 1
        assert ours.router.spills > 0


def test_region_sim_over_a_mesh_places_replicas_round_robin(fleet_models):
    """Replica r runs on the mesh's device r % n over one weight copy a
    device; on a mesh of two CPU entries the drive is the one-device
    drive, bit for bit."""
    fm = fleet_models
    grid = np.empty((2, 1), dtype=object)
    grid[0, 0] = grid[1, 0] = torch.device("cpu")
    sessions = generate_workload(3.0, 1.5, seed=0, time_scale=0.2)
    sims = [RegionSim(fm["splits"], fm["placed"], n_replicas=3,
                      router=ConsistentHashRouter(3),
                      engine_kw=dict(ENGINE_KW, time_fn=StepClock()),
                      device="cpu", **kw)
            for kw in ({}, {"mesh": FleetMesh(grid)})]
    for sim in sims:
        sim.run(sessions, lambda sid, ev: fm["payloads"][ev.modality])
    one, two = sims
    assert [e.device for e in two.replicas] == [torch.device("cpu")] * 3
    assert all(e.params is fm["placed"] for e in two.replicas)
    assert one.flush_log == two.flush_log and one.route_of == two.route_of
    for s in sessions:
        a, b = one.final_outputs(s.sid), two.final_outputs(s.sid)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_region_sim_shed_sessions_degrade_only(fleet_models, tmp_path):
    fm = fleet_models
    sessions = generate_workload(3.0, 2.0, seed=1, time_scale=0.2)
    assert len(sessions) <= 8
    ctrl = AdmissionController(AdmissionPolicy(
        deadline_s=SHED_ALL, enter_frac=1.0, exit_frac=0.5), 2)
    path = tmp_path / "fleet.jsonl"
    tracer = StreamingTracer(path, buffer=16)
    sim = RegionSim(fm["splits"], fm["placed"], n_replicas=2,
                    admission=ctrl, profile=GLASS_PROFILE, tracer=tracer,
                    engine_kw=dict(ENGINE_KW), device="cpu")
    rep = sim.run(sessions, lambda sid, ev: fm["payloads"][ev.modality])

    n = len(sessions)
    assert rep["sessions_offered"] == n
    assert rep["sessions_admitted"] + rep["sessions_shed"] == n
    assert rep["sessions_shed"] == n == ctrl.shed
    assert len(sim.glass.records) == sum(len(s.events) for s in sessions)
    assert all(r.kind == "partial" and r.degraded
               for r in sim.glass.records)
    assert rep["degraded_partials"] == sum(
        1 for r in sim.glass.records if r.outputs is not None) > 0
    assert all(sim.final_outputs(s.sid) is None for s in sessions)
    assert sim.metrics.get("fleet.degraded_events") == \
        len(sim.glass.records)
    assert set(sim.glass.ttfp) == {s.sid for s in sessions}

    tracer.close(other_data={"metrics": sim.fleet_metrics().snapshot()})
    report = audit_file(path)
    assert report.ok, report.violations


def test_region_sim_shed_all_equals_reference(fleet_models):
    sessions = generate_workload(3.0, 2.0, seed=1, time_scale=0.2)
    ours, ref = _run_pair(fleet_models, sessions, deadline=SHED_ALL)
    _same_sims(ours, ref, sessions)
    assert ours.report()["sessions_shed"] == len(sessions)
    assert len(ours.glass.records) == sum(len(s.events) for s in sessions)


def test_region_sim_mixed_admission_equals_reference(fleet_models):
    """50 ms a flush against a 80 ms deadline: the controller enters its
    shedding state part way through, so some sessions are served by the
    replicas and the rest by the glass path."""
    sessions = generate_workload(3.0, 1.5, seed=0, time_scale=0.2)
    ours, ref = _run_pair(fleet_models, sessions, step=5e-2, deadline=0.08)
    _same_sims(ours, ref, sessions)
    rep = ours.report()
    assert rep["sessions_admitted"] > 0 and rep["sessions_shed"] > 0
    assert ours.admission.transitions == ref.admission.transitions != []
