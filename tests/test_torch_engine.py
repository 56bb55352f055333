"""The port's per-event serving path against the JAX reference, on the CPU.

Both engines serve Table-6 episodes with the same weights (the JAX
initialiser's, converted through numpy), the same numpy payloads and ONE
fixed ``ProfileTable`` written out here: tier decisions follow profiled
times, so two ``profile()`` runs would make the sequences differ for no
fault of either side. The reference runs its launcher default (einsum
text attention); the port runs its default (the flash wrapper, whose
plain version serves CPU tensors). Recommendations agree at atol 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs.emsnet import tiny as jax_tiny
from repro.obs import Metrics as JMetrics
from repro.obs import Tracer as JTracer
from repro_torch import core as P
from repro_torch.configs.emsnet import tiny
from repro_torch.convert import from_jax_numpy
from repro_torch.core import splitter as PS
from repro_torch.launch import serve as PL
from repro_torch.models.quantized import quantize_emsnet_params
from repro_torch.obs import Metrics, Tracer

ATOL = 1e-5
TEXT = "microbert"
PROFILE = {"enc:text": 0.05, "enc:vitals": 0.001, "enc:scene": 0.004,
           "tail": 0.001, "full": 0.06}


@pytest.fixture(scope="module")
def zoo():
    jcfg, cfg = jax_tiny(text_encoder=TEXT), tiny(text_encoder=TEXT)
    mods = {"m1": ("text",), "m2": ("text", "vitals"),
            "m3": ("text", "vitals", "scene")}
    jsplits = {k: J.split(J.emsnet_module(jcfg, m)) for k, m in mods.items()}
    jparams = {k: s.module.init_fn(jax.random.fold_in(jax.random.PRNGKey(0), i))
               for i, (k, s) in enumerate(jsplits.items())}
    psplits = {k: P.split(P.emsnet_module(cfg, m)) for k, m in mods.items()}
    pparams = {k: from_jax_numpy(jax.device_get(p), "cpu")
               for k, p in jparams.items()}
    rng = np.random.default_rng(0)
    payloads = {
        "text": rng.integers(1, cfg.vocab_size,
                             (1, cfg.max_text_len)).astype(np.int32),
        "vitals": rng.normal(size=(1, cfg.vitals_len,
                                   cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }
    return jsplits, jparams, psplits, pparams, payloads


def _policy(pkg, mobility=True):
    if mobility:
        dist = list(np.linspace(0, 30, 11)) + list(np.linspace(30, 0, 11))
        trace = pkg.BandwidthTrace.walk(dist, pkg.nlos_bandwidth, period=1.0)
    else:
        trace = pkg.BandwidthTrace.static(pkg.nlos_bandwidth(5.0))
    return pkg.AdaptiveOffloadPolicy(pkg.ProfileTable(base=dict(PROFILE)),
                                     pkg.HeartbeatMonitor(trace))


def _serve(pkg, splits, params, payloads, episode, *, crash_at=-1,
           cached=True, bucketer=None, aggregate=None, **kw):
    """``episode``: a Table-6 number or a ``LAG_SCENARIOS`` name."""
    eng = pkg.EMSServe(splits, params, policy=_policy(pkg), cached=cached,
                       bucketer=bucketer, **kw)
    events = (pkg.table6()[episode] if isinstance(episode, int)
              else pkg.async_episode(episode, seed=0))
    nbytes = []
    for i, ev in enumerate(events):
        if i == crash_at:
            eng.crash_edge()
        eng.on_event(ev, payloads[ev.modality], aggregate=aggregate)
        size = (J.payload_nbytes if pkg is J else P.payload_nbytes)
        nbytes.append(sorted((k, e.step, e.version, e.tier, size(e.feature))
                             for k, e in eng.cache.entries()))
    return eng, nbytes


def _same_records(jeng, peng, n=21):
    assert len(jeng.records) == len(peng.records) == n
    for a, b in zip(jeng.records, peng.records):
        assert (a.index, a.modality, a.model, a.tier, a.cache_hits) == \
            (b.index, b.modality, b.model, b.tier, b.cache_hits)
        assert a.delta_t == pytest.approx(b.delta_t, abs=1e-12)
        assert a.cumulative_s == pytest.approx(b.cumulative_s, abs=1e-12)
        assert (a.recommendation is None) == (b.recommendation is None)
        if a.recommendation is not None:
            for k in a.recommendation:
                np.testing.assert_allclose(b.recommendation[k].numpy(),
                                           np.asarray(a.recommendation[k]),
                                           atol=ATOL, rtol=0)


@pytest.mark.parametrize("episode, crash_at", [(1, 8), (2, 12), (3, 5)])
def test_emsserve_matches_reference_on_table6(zoo, episode, crash_at):
    jsplits, jparams, psplits, pparams, payloads = zoo
    jeng, jbytes = _serve(J, jsplits, jparams, payloads, episode,
                          crash_at=crash_at)
    peng, pbytes = _serve(P, psplits, pparams, payloads, episode,
                          crash_at=crash_at, device="cpu")
    _same_records(jeng, peng)
    assert pbytes == jbytes            # every committed feature, event by event
    assert {r.tier for r in peng.records[crash_at:]} == {"glass"}
    assert peng.cache.hits == jeng.cache.hits
    assert peng.compile_count() == 0


@pytest.mark.parametrize("scenario", sorted(J.LAG_SCENARIOS))
def test_emsserve_matches_reference_on_lag_scenarios(zoo, scenario):
    jsplits, jparams, psplits, pparams, payloads = zoo
    jeng, jbytes = _serve(J, jsplits, jparams, payloads, scenario,
                          crash_at=4)
    peng, pbytes = _serve(P, psplits, pparams, payloads, scenario,
                          crash_at=4, device="cpu")
    _same_records(jeng, peng, n=len(J.async_episode(scenario, seed=0)))
    assert pbytes == jbytes


def test_direct_path_matches_reference(zoo):
    jsplits, jparams, psplits, pparams, payloads = zoo
    jeng, _ = _serve(J, jsplits, jparams, payloads, 2, cached=False)
    peng, _ = _serve(P, psplits, pparams, payloads, 2, cached=False,
                     device="cpu")
    _same_records(jeng, peng)


def test_bucketed_growing_vitals_match_reference(zoo):
    """Vitals accumulate across events (the bucketer pads them to
    power-of-two lengths with a ``len`` vector); text pads to its bucket."""
    jsplits, jparams, psplits, pparams, payloads = zoo
    caps = {"text": 16}
    jeng, _ = _serve(J, jsplits, jparams, payloads, 1,
                     bucketer=J.Bucketer(max_buckets=caps),
                     aggregate=lambda o, n: n if o is None or n.ndim != 3
                     else jnp.concatenate([o, n], axis=1))
    peng, _ = _serve(P, psplits, pparams, payloads, 1,
                     bucketer=P.Bucketer(max_buckets=caps),
                     aggregate=lambda o, n: n if o is None or n.ndim != 3
                     else torch.cat([o, n], dim=1), device="cpu")
    _same_records(jeng, peng)
    assert peng.bucketer.histogram == jeng.bucketer.histogram


def test_feature_sizes_and_payload_nbytes_match_reference(zoo):
    jsplits, jparams, psplits, pparams, payloads = zoo
    jb = {m: jnp.asarray(x) for m, x in payloads.items()}
    tb = {m: torch.from_numpy(x) for m, x in payloads.items()}
    assert P.feature_sizes(psplits["m3"], pparams["m3"], tb) == \
        J.feature_sizes(jsplits["m3"], jparams["m3"], jb)
    tree = {"a": np.zeros((3, 2), np.float32), "b": [1, 2.5],
            "c": (np.int8(1), None)}
    assert P.payload_nbytes(tree) == J.payload_nbytes(tree)
    assert P.payload_nbytes(torch.zeros((2, 5), dtype=torch.int8)) == 10


def test_profile_on_cpu_times_every_submodule(zoo):
    _, _, psplits, pparams, payloads = zoo
    t = P.profile(psplits["m3"], pparams["m3"], payloads, iters=1,
                  device="cpu")
    assert set(t) == {"enc:text", "enc:vitals", "enc:scene", "tail", "full"}
    assert all(v > 0 for v in t.values())


def test_cuda_entry_points_raise_without_a_card(zoo):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, psplits, pparams, payloads = zoo
    cfg = tiny(text_encoder=TEXT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.EMSServe(psplits, pparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.build_models(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.profile(psplits["m3"], pparams["m3"], payloads)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.main(["--text-encoder", TEXT])


def test_launcher_serves_on_cpu(capsys):
    PL.main(["--text-encoder", TEXT, "--episode", "2", "--mobility",
             "--crash-edge-at", "12", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 24 and out[-1].endswith("on cpu")
    assert any("edge server crash" in ln for ln in out)
    assert all("tier=glass" in ln for ln in out[14:22])


def test_build_models_is_seeded_per_model():
    cfg = tiny(text_encoder=TEXT)
    s1, p1 = PL.build_models(cfg, seed=1, device="cpu")
    _, p2 = PL.build_models(cfg, seed=1, device="cpu")
    assert torch.equal(p1["m3"]["heads"]["protocol"]["w"],
                       p2["m3"]["heads"]["protocol"]["w"])
    assert not torch.equal(p1["m1"]["text"]["tok"]["emb"],
                           p1["m2"]["text"]["tok"]["emb"])
    assert [s.modalities() for s in s1.values()] == \
        [("text",), ("text", "vitals"), ("text", "vitals", "scene")]


# ------------------------------------------------------ selection, zoo

class _Fake:
    def __init__(self, *mods):
        self._mods = tuple(mods)

    def modalities(self):
        return self._mods


def test_select_model_ties_match_reference():
    from itertools import combinations, permutations
    from repro.core.splitter import select_model as jsel
    subsets = [c for r in (1, 2, 3)
               for c in combinations(("text", "vitals", "scene"), r)]
    names = ["a", "b", "c", "d"]
    for observed in subsets:
        for pick in combinations(subsets, 3):
            for order in list(permutations(range(3)))[:3]:
                models = {names[i]: _Fake(*pick[i]) for i in order}
                assert PS.select_model(models, observed) == \
                    jsel(models, observed)


def test_zoo_matches_reference_layout():
    jzoo = J.emsnet_zoo(jax_tiny(text_encoder=TEXT))
    pzoo = P.emsnet_zoo(tiny(text_encoder=TEXT))
    assert list(pzoo) == list(jzoo)
    for k in jzoo:
        a, b = jzoo[k], pzoo[k]
        assert (a.name, a.modalities, a.payload_bytes, a.max_lengths,
                a.feature_dims) == (b.name, b.modalities, b.payload_bytes,
                                    b.max_lengths, b.feature_dims)
        # both declare their int8 sidecar derivation
        assert a.quantize_fn is not None
        assert b.quantize_fn is quantize_emsnet_params


def test_subset_module_serves_from_one_full_param_dict(zoo):
    _, _, _, pparams, payloads = zoo
    cfg = tiny(text_encoder=TEXT)
    zoo_ = P.emsnet_zoo(cfg)
    tb = {m: torch.from_numpy(x) for m, x in payloads.items()}
    from repro_torch.models import emsnet as E
    for key, mod in zoo_.items():
        out = mod.full_fn()(pparams["m3"], tb)
        want = E.partial_forward(pparams["m3"], cfg, tb, mod.modalities)
        for k in want:
            assert torch.equal(out[k], want[k]), key


# ------------------------------------------------------- feature cache

def test_cache_idempotent_monotone_and_stale_like_reference():
    for C in (J.FeatureCache, P.FeatureCache):
        c = C(max_staleness=1)
        assert c.put("s", "t", 1.0, step=3, tier="glass")
        assert not c.put("s", "t", 2.0, step=3, tier="edge")     # duplicate
        assert not c.put("s", "t", 0.0, step=2, tier="edge")     # older
        e = c.get("s", "t", input_step=4)
        assert (e.feature, e.step, e.version, e.tier) == (1.0, 3, 0, "glass")
        assert (c.duplicate_commits, c.stale_commits) == (1, 1)
        with pytest.raises(Exception, match="lags its input"):
            c.get("s", "t", input_step=5)
        c.touch("s", "t", 5)
        assert c.get("s", "t", input_step=5).feature == 1.0
        assert c.put("s", "t", 3.0, step=6)
        assert c.get("s", "t").version == 1
        c.put("s", "v", 1, step=1, tier="edge")
        c.drop_tier("edge")
        assert c.get("s", "v") is None and c.misses == 1
        assert c.drop_session("s") == 1 and len(c) == 0
    assert issubclass(P.StalenessError, RuntimeError)


def test_cache_trace_exports_like_reference(tmp_path):
    files = []
    for C, T in ((J.FeatureCache, JTracer), (P.FeatureCache, Tracer)):
        tr = T()
        c = C(tracer=tr)
        tr.set_time(0.5)
        c.put("s", "t", 1.0, step=1)
        c.put("s", "t", 1.0, step=1)
        c.touch("s", "t", 2)
        tr.span("encode", "compute", 0.5, 0.75, track="host:glass", m="t")
        c.drop_session("s")
        path = tmp_path / f"{len(files)}.json"
        assert tr.export(path) == 5
        files.append(path.read_bytes())
    assert files[0] == files[1]
    assert not Tracer.disabled and not JTracer.disabled


def test_metrics_snapshot_matches_reference():
    rng = np.random.default_rng(0)
    vals = rng.exponential(0.01, 200).tolist() + [0.0, 1e-3]
    snaps = []
    for M in (JMetrics, Metrics):
        m = M()
        for v in vals:
            m.observe("serve.latency_s", v)
        m.inc("cache.hits", 3)
        m.set_gauge("sessions", 2)
        snaps.append(json.dumps(m.snapshot(), sort_keys=True))
        m.reset()
        assert m.snapshot() == {"counters": {}, "gauges": {},
                                "histograms": {}}
    assert snaps[0] == snaps[1]


# ------------------------------------------- episodes, offload, buckets

def _ev(events):
    return [(e.index, e.modality, e.arrival_time) for e in events]


def test_episodes_match_reference():
    p6, j6 = P.table6(0.5), J.table6(0.5)
    assert {k: _ev(v) for k, v in p6.items()} == \
        {k: _ev(v) for k, v in j6.items()}
    for seed in range(3):
        assert _ev(P.random_episode(12, seed)) == \
            _ev(J.random_episode(12, seed))
        for sc in P.LAG_SCENARIOS:
            assert _ev(P.async_episode(sc, seed)) == \
                _ev(J.async_episode(sc, seed))
    peps = {"a": p6[1], "b": p6[3]}
    jeps = {"a": j6[1], "b": j6[3]}
    assert [(t, s, _ev([e])) for t, s, e in P.merge_arrivals(peps)] == \
        [(t, s, _ev([e])) for t, s, e in J.merge_arrivals(jeps)]
    assert P.horizon(peps) == J.horizon(jeps)


def test_offload_decisions_match_reference():
    assert P.TIER_FACTORS == J.TIER_FACTORS
    dist = list(np.linspace(0, 60, 31))
    for adaptive, force in ((True, None), (False, None), (True, "glass")):
        pols = [pkg.AdaptiveOffloadPolicy(
            pkg.ProfileTable(base=dict(PROFILE)),
            pkg.HeartbeatMonitor(pkg.BandwidthTrace.walk(
                dist, pkg.nlos_bandwidth, period=0.7), period=1.0),
            adaptive=adaptive, force=force) for pkg in (J, P)]
        for t in np.linspace(-1, 25, 60):
            for sub, nb in (("enc:text", 480000), ("enc:scene", 921600),
                            ("enc:vitals", 720)):
                a, b = (p.decide(sub, nb, float(t)) for p in pols)
                assert (a.tier, a.delta_t, a.t_edge, a.t_glass) == \
                    (b.tier, b.delta_t, b.t_edge, b.t_glass)
    with pytest.raises(ValueError):
        P.BandwidthTrace([])


def test_bucketing_matches_reference():
    from repro.core import bucketing as JB
    from repro_torch.core import bucketing as PB
    for n in range(0, 70):
        assert PB.next_pow2(n) == JB.next_pow2(n)
        assert PB.bucket_length(n, max_bucket=48) == \
            JB.bucket_length(n, max_bucket=48)
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    for length, keep in ((8, "tail"), (3, "tail"), (3, "head"), (5, "head")):
        np.testing.assert_array_equal(
            PB.pad_axis(torch.from_numpy(x), length, 1, keep=keep).numpy(),
            np.asarray(JB.pad_axis(jnp.asarray(x), length, 1, keep=keep)))
    jb, pb = JB.Bucketer(max_buckets={"text": 12}), PB.Bucketer(
        max_buckets={"text": 12})
    toks = np.ones((1, 5), np.int32)
    np.testing.assert_array_equal(pb.fit("text", torch.from_numpy(toks)).numpy(),
                                  np.asarray(jb.fit("text", jnp.asarray(toks))))
    jv = jb.fit("vitals", jnp.asarray(x))
    pv = pb.fit("vitals", torch.from_numpy(x))
    np.testing.assert_array_equal(pv["x"].numpy(), np.asarray(jv["x"]))
    np.testing.assert_array_equal(pv["len"].numpy(), np.asarray(jv["len"]))
    assert pb.histogram == jb.histogram and pb.n_buckets() == 2
