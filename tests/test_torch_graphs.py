"""The port's counterpart of ``jax.jit`` (``repro_torch.graphs``): the
signature key, ``split(jit=...)``, and the reference's compile-count
plateau tests mirrored on the port's engines, on the CPU.

On the CPU a ``Graphed`` piece runs eagerly and counts the signatures a
card run would capture, so the count and every output are checked here;
the capture itself (static buffers, replay, the kernel counters' replay
bookkeeping, a failing capture raising) runs only on a card
(``test_capture_replays_on_card``; ``chip_smoke.py`` drives every served
path with graphs).

Tolerances: engine outputs against the reference 1e-5, float32 on both
sides summed in another order (the reference's own tolerance in
``tests/test_batch_serving.py``); graphed against eager pieces and
servers exactly (the same eager calls on the CPU); counts exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.emsnet import tiny as jax_tiny
from repro.models import transformer as JT
from repro.serving.batch_engine import BatchedEMSServe as JBatched
from repro.serving.engine import LLMServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.stream_engine import StreamingEMSServe as JStreaming
from repro_torch import core as P
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs.emsnet import tiny
from repro_torch.convert import from_jax_numpy
from repro_torch.graphs import Graphed
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serving.batch_engine import BatchedEMSServe
from repro_torch.serving.engine import LLMServer, Request
from repro_torch.serving.stream_engine import StreamingEMSServe

ATOL = 1e-5
TEXT = "microbert"
ALL = ("text", "vitals", "scene")


def _cfgs():
    return jax_tiny(text_encoder=TEXT), tiny(text_encoder=TEXT)


def _payloads(cfg):
    """The reference plateau tests' payloads: an 11-token utterance, one
    vitals step, a scene vector."""
    rng = np.random.default_rng(0)
    return {
        "text": rng.integers(1, cfg.vocab_size, (1, 11)).astype(np.int32),
        "vitals": rng.normal(size=(1, 1, cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def indep():
    """m1/m2/m3 with their own weights, as the reference's batch tests."""
    jcfg, cfg = _cfgs()
    mods = {"m1": ("text",), "m2": ("text", "vitals"), "m3": ALL}
    jsplits = {k: J.split(J.emsnet_module(jcfg, m)) for k, m in mods.items()}
    key = jax.random.PRNGKey(0)
    jparams = {k: jax.jit(s.module.init_fn)(jax.random.fold_in(key, i))
               for i, (k, s) in enumerate(jsplits.items())}
    modules = {k: P.emsnet_module(cfg, m) for k, m in mods.items()}
    pparams = {k: from_jax_numpy(jax.device_get(p), "cpu")
               for k, p in jparams.items()}
    return cfg, jsplits, jparams, modules, pparams, _payloads(cfg)


@pytest.fixture(scope="module")
def zoo():
    """The 7-model subset zoo over one shared parameter dict."""
    jcfg, cfg = _cfgs()
    jzoo = J.emsnet_zoo(jcfg)
    jsplits = {k: J.split(m) for k, m in jzoo.items()}
    jshared = jax.jit(jzoo["text+vitals+scene"].init_fn)(
        jax.random.PRNGKey(0))
    pshared = from_jax_numpy(jax.device_get(jshared), "cpu")
    rng = np.random.default_rng(0)
    payloads = {
        "text": rng.integers(1, cfg.vocab_size, (1, 11)).astype(np.int32),
        "vitals": rng.normal(size=(1, 5, cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }
    return (cfg, jsplits, {k: jshared for k in jsplits}, P.emsnet_zoo(cfg),
            {k: pshared for k in jsplits}, payloads)


def _jagg(old, new):
    if old is not None and new.ndim == 3:
        return jnp.concatenate([old, new], axis=1)
    return new


def _pagg(old, new):
    if old is not None and new.dim() == 3:
        return torch.cat([old, new], dim=1)
    return new


def _close(got, want, ctx=""):
    assert sorted(got) == sorted(want), ctx
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=f"{ctx}[{k}]")


# ------------------------------------------------------------------ the key

def _affine(p, x, scale=1.0):
    return (x.float() @ p["w"]) * scale


def test_signature_keys_shape_dtype_stride_params_and_values():
    fn = Graphed(_affine)
    p, p2 = {"w": torch.ones((4, 3))}, {"w": torch.ones((4, 3))}
    x = torch.ones((2, 4))
    fn(p, x)
    fn(p, torch.zeros((2, 4)))                 # new values, same signature
    assert fn.compile_count() == 1
    steps = [
        lambda: fn(p, torch.ones((5, 4))),                       # shape
        lambda: fn(p, torch.ones((2, 4), dtype=torch.float64)),  # dtype
        lambda: fn(p, torch.ones((4, 2)).T),                     # strides
        lambda: fn(p2, x),                                       # another param
        lambda: fn(p, x, 2.0),                                   # a value
        lambda: fn(p, x, 2),                                     # its type
    ]
    for i, step in enumerate(steps):
        step()
        assert fn.compile_count() == i + 2, i
    for step in steps:                         # every one of them again
        step()
    assert fn.compile_count() == 1 + len(steps)


def test_signature_keys_tree_structure():
    fn = Graphed(lambda p, feats: sum(f.sum() for f in feats.values()))
    p = {}
    fn(p, {"a": torch.ones(2), "b": torch.ones(2)})
    fn(p, {"a": torch.ones(2), "c": torch.ones(2)})
    fn(p, {"a": torch.ones(2)})
    fn(p, {"a": torch.ones(2), "b": torch.ones(2)})
    assert fn.compile_count() == 3


def test_graphed_returns_the_eager_result_on_cpu():
    fn = Graphed(_affine)
    p = {"w": torch.arange(12.0).reshape(4, 3)}
    x = torch.arange(8.0).reshape(2, 4)
    assert torch.equal(fn(p, x, 0.5), _affine(p, x, 0.5))


# ------------------------------------------------------------ split(jit=)

def test_split_without_jit_counts_zero_and_matches(indep):
    """``jit=False`` pieces are the module's own functions and count 0;
    with ``jit=True`` the same drive gives the same outputs and the same
    kernel calls, and counts one signature per piece and shape."""
    cfg, _, _, modules, pparams, payloads = indep
    runs = {}
    for jit in (False, True):
        splits = {k: P.split(m, jit=jit) for k, m in modules.items()}
        if not jit:
            assert all(sm.encoders[m] is sm.module.encoder_fns[m]
                       for sm in splits.values() for m in sm.modalities())
        eng = P.EMSServe(splits, pparams, cached=True, real_time=True,
                         device="cpu")
        before = FA.flash_attention.calls
        eng.run_episode(P.table6()[2], lambda ev: payloads[ev.modality])
        runs[jit] = (eng, FA.flash_attention.calls - before)
    (eager, eager_calls), (graphed, graphed_calls) = runs[False], runs[True]
    assert eager.compile_count() == 0
    assert graphed_calls == eager_calls > 0
    assert len(eager.records) == len(graphed.records)
    for a, b in zip(eager.records, graphed.records):
        assert (a.model, a.cache_hits) == (b.model, b.cache_hits)
        assert (a.recommendation is None) == (b.recommendation is None)
        if a.recommendation is not None:
            for k in a.recommendation:
                assert torch.equal(a.recommendation[k], b.recommendation[k])
    # one signature per piece served: each consuming model's encoder of
    # every arrived modality, each tail used
    served = {(n, r.modality) for r in graphed.records
              for n, m in modules.items() if r.modality in m.modalities}
    served |= {(r.model, "tail") for r in graphed.records
               if r.recommendation is not None}
    assert graphed.compile_count() == len(served) > 0


# ------------------------------- the reference's plateau tests, mirrored

def test_compile_count_plateaus_with_growing_vitals(indep):
    """tests/test_batch_serving.py::
    test_compile_count_plateaus_with_growing_vitals on the port: once the
    bucket grid is warm, growing vitals streams add no signature, and
    every flush's recommendations match the reference's."""
    cfg, jsplits, jparams, modules, pparams, payloads = indep
    splits = {k: P.split(m) for k, m in modules.items()}
    jeng = JBatched(jsplits, jparams, bucketer=J.Bucketer(
        min_bucket=4, max_buckets={"vitals": 4}), batch_bucket_min=2)
    peng = BatchedEMSServe(splits, pparams, bucketer=P.Bucketer(
        min_bucket=4, max_buckets={"vitals": 4}), batch_bucket_min=2,
        device="cpu")
    t = 0

    def send(kind):
        nonlocal t
        for sid in ("a", "b"):
            jeng.submit(sid, J.Event(t, kind, float(t)),
                        jnp.asarray(payloads[kind]), aggregate=_jagg)
            peng.submit(sid, P.Event(t, kind, float(t)), payloads[kind],
                        aggregate=_pagg)
        jrep, prep = jeng.flush(), peng.flush()
        assert sorted(prep.recommendations) == sorted(jrep.recommendations)
        for sid in jrep.recommendations:
            _close(prep.recommendations[sid], jrep.recommendations[sid],
                   f"{kind}@{t}:{sid}")
        t += 1

    for kind in ("text", "scene", "vitals", "vitals", "vitals", "vitals",
                 "vitals"):
        send(kind)
    warm = peng.compile_count()
    # m1/m2/m3 text, m2/m3 vitals (the one capped bucket), m3 scene, and
    # the m1 and m3 tails, each at 2 rows
    assert warm == 8
    for _ in range(6):                     # streams keep growing
        send("vitals")
    assert peng.compile_count() == warm
    assert peng.sessions["a"].inputs["vitals"].shape[1] > 4


def test_per_event_engine_bucketed_bounds_compiles(indep):
    """tests/test_batch_serving.py::
    test_per_event_engine_bucketed_bounds_compiles on the port."""
    cfg, jsplits, jparams, modules, pparams, payloads = indep
    splits = {k: P.split(m) for k, m in modules.items()}
    jeng = J.EMSServe(jsplits, jparams, cached=True, real_time=True,
                      bucketer=J.Bucketer(min_bucket=4,
                                          max_buckets={"vitals": 4}))
    peng = P.EMSServe(splits, pparams, cached=True, real_time=True,
                      bucketer=P.Bucketer(min_bucket=4,
                                          max_buckets={"vitals": 4}),
                      device="cpu")

    def event(t, kind):
        ja = jeng.on_event(J.Event(t, kind, float(t)),
                           jnp.asarray(payloads[kind]), aggregate=_jagg)
        pa = peng.on_event(P.Event(t, kind, float(t)), payloads[kind],
                           aggregate=_pagg)
        assert (pa.model, pa.cache_hits) == (ja.model, ja.cache_hits)
        _close(pa.recommendation, ja.recommendation, f"{kind}@{t}")

    event(0, "text")
    for t in range(1, 6):
        event(t, "vitals")
    warm = peng.compile_count()
    for t in range(6, 12):
        event(t, "vitals")
    assert peng.compile_count() == warm > 0


def test_refusion_never_reencodes_cached_modalities(zoo):
    """tests/test_stream_parity.py::
    test_refusion_never_reencodes_cached_modalities on the port: after
    warm-up, re-arrivals of one modality re-encode only it, re-fuse from
    the cache, and add no signature."""
    cfg, jsplits, jparams, pzoo, pparams, payloads = zoo
    splits = {k: P.split(m) for k, m in pzoo.items()}

    def bucketer(pkg):
        return pkg.Bucketer(max_buckets={"vitals": 8,
                                         "text": cfg.max_text_len})

    jeng = JStreaming(jsplits, jparams, share_encoders=True,
                      bucketer=bucketer(J))
    peng = StreamingEMSServe(splits, pparams, share_encoders=True,
                             bucketer=bucketer(P), device="cpu")

    def submit(i, m):
        jrep = jeng.submit("s0", J.Event(i, m, float(i)),
                           jnp.asarray(payloads[m]))
        prep = peng.submit("s0", P.Event(i, m, float(i)), payloads[m])
        assert [(p.model, p.kind) for p in prep.predictions] == \
            [(p.model, p.kind) for p in jrep.predictions]
        for a, b in zip(prep.predictions, jrep.predictions):
            _close(a.outputs, b.outputs, f"{m}@{i}")
        return prep

    for i, m in enumerate(ALL):
        submit(i, m)
    warm = peng.compile_count()
    enc_before = peng.encoder_calls_total()
    hits_before = peng.cache.hits
    for i in range(3, 8):                       # vitals keep refreshing
        rep = submit(i, "vitals")
        assert rep.n_encoder_calls == 1         # vitals only
        assert rep.predictions[0].kind == "final"
    assert peng.encoder_calls_total() == enc_before + 5
    assert peng.cache.hits >= hits_before + 10
    assert peng.compile_count() == warm > 0


# ---------------------------------------------------------------- LLMServer

def _two_layers(cfg):
    return dataclasses.replace(cfg, groups=((cfg.groups[0][0], 2),),
                               n_layers=2, dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def llm(request):
    jcfg = _two_layers(jreduced(jget_config(request.param), d_model=128))
    cfg = _two_layers(reduced(get_config(request.param), d_model=128))
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, from_jax_numpy(jax.device_get(jp), "cpu")


def _mix(srv, request_cls):
    system = np.arange(1, 33, dtype=np.int32)
    out = [srv.serve_one(request_cls("warm", system, max_new_tokens=1))]
    for i in range(3):
        u = np.array([40 + i, 50 + i], np.int32)
        out.append(srv.serve_one(request_cls(
            f"u{i}", np.concatenate([system, u]), max_new_tokens=6)))
    out.append(srv.serve_one(request_cls("again", system, max_new_tokens=3)))
    return out


def test_llm_server_graphed_matches_eager_and_reference(llm):
    """The decode step over the server's static state: one signature per
    (arch, B=1, cache_len) with ``jit``, none without; tokens and stats
    equal the eager server's and the reference server's."""
    jcfg, cfg, jp, p = llm
    want = _mix(JServer(jcfg, jp, cache_len=64), JRequest)
    jstats = JServer(jcfg, jp, cache_len=64)
    _mix(jstats, JRequest)
    runs = {}
    for jit in (True, False):
        srv = LLMServer(cfg, p, cache_len=64, jit=jit, device="cpu")
        runs[jit] = (srv, _mix(srv, Request))
    (graphed, res), (eager, eager_res) = runs[True], runs[False]
    assert graphed.compile_count() == 1 and eager.compile_count() == 0
    assert graphed.stats == eager.stats == jstats.stats
    for a, b, c in zip(res, eager_res, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, np.asarray(c.tokens))
        assert (a.prefix_hit, a.prefill_tokens) == (c.prefix_hit,
                                                    c.prefill_tokens)


def test_llm_server_snapshots_survive_the_static_cache(llm):
    """Every stored prefix entry stays byte-identical while later hits
    decode over the server's one static cache, and is never that cache."""
    _, cfg, _, p = llm
    srv = LLMServer(cfg, p, cache_len=64, device="cpu")
    system = np.arange(1, 17, dtype=np.int32)
    srv.serve_one(Request("sys", system, max_new_tokens=4))
    stored = {k: T.clone(v[0]) for k, v in srv.prefix_cache.items()}
    for i in range(3):
        r = srv.serve_one(Request(f"u{i}", np.concatenate(
            [system, [60 + i]]).astype(np.int32), max_new_tokens=5))
        assert r.prefix_hit
    static = {id(t) for t in _leaves(srv._state["cache"])}
    for k, before in stored.items():
        after = srv.prefix_cache[k][0]
        for a, b in zip(_leaves(after), _leaves(before)):
            assert id(a) not in static
            assert torch.equal(a, b)
    assert srv.compile_count() == 1


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_copy_cache_refuses_another_layout(llm):
    _, cfg, _, _ = llm
    a = T.init_cache(cfg, 1, 16, device="cpu")
    src = T.init_cache(cfg, 1, 16, device="cpu")
    for t in _leaves(src):
        t.fill_(3)
    assert T.copy_cache(a, src) is a
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(src)))
    with pytest.raises(ValueError, match="cache leaf"):
        T.copy_cache(a, T.init_cache(cfg, 2, 16, device="cpu"))


# ------------------------------------------------------------------- card

def test_capture_replays_on_card():
    """Runs only where a CUDA card is present (chip_smoke.py drives every
    served path with graphs): the first call is eager and captures, a
    later call replays into fresh outputs, the kernel counters tick once
    per call either way, and a capture that copies from the host raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn((26, 26), generator=g).to(dev)}

    def attend(p, x):
        q = (x @ p["w"]).reshape(1, 8, 1, 26)
        return ops.flash_attention(q, q, q, causal=False)

    fn = Graphed(attend)
    xs = [torch.randn((8, 26), generator=g).to(dev) for _ in range(3)]
    before = (FA.flash_attention.launches, FA.flash_attention.calls)
    outs = [fn(p, x) for x in xs]
    assert fn.compile_count() == 1 and fn.capture_s > 0
    assert (FA.flash_attention.launches, FA.flash_attention.calls) == \
        (before[0] + 3, before[1] + 3)
    for x, out in zip(xs, outs):
        assert torch.equal(out, attend(p, x))
    assert outs[1].data_ptr() != outs[2].data_ptr()

    # the warm-up call copies from the host eagerly; its capture raises
    bad = Graphed(lambda p, x: x + torch.ones(x.shape).to(x.device))
    with pytest.raises(RuntimeError):
        bad(p, xs[0])
