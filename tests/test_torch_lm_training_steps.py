"""LM training steps of the LLM zoo on the CPU: ``trainer.make_train_step``
against the reference's, the reference's per-arch smoke cases on the
port, and what a step runs.

- One step against the reference's ``jax.jit(make_train_step(cfg))``:
  AdamW with one microbatch (the reduced configs' own settings), and
  ``optimizer="adafactor"`` with ``remat=True`` and
  ``train_microbatches=2`` set on both sides by ``dataclasses.replace``.
  The loss and grad norm within 1e-5 (relative), every parameter within
  1e-5, every optimizer-state leaf within 1e-4 of its max |x|. A first
  AdamW step moves each parameter by lr * sign(g) (lr 3e-6 at step 1 of
  the warmup), so the parameters alone would hide wrong gradients:
  ``test_torch_lm_training*.py`` hold every gradient leaf first.
- ``tests/test_archs_smoke.py``'s cases for every arch on the port:
  finite logits of the expected shapes (and ``mtp_logits``), one step
  that moves the parameters with a finite loss and grad norm, and a
  prefill then a decode step equal to ``forward_train`` at 5e-4.
- Under remat the RWKV6 scan's forward runs twice a layer a microbatch
  (the period is recomputed for its backward), its backward once;
  ``kernel="pallas"`` reaches the flash kernel under autograd and raises.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.training import trainer as JTR
from repro_torch.configs import ARCHS
from repro_torch.kernels import rwkv6 as RW
from repro_torch.models import transformer as T
from repro_torch.training import trainer as TR
from repro_torch.training import tree as TT
from test_torch_lm_training import as_jax, as_torch, batch, cfgs, init

STEP_ATOL = 1e-5
STATE_RTOL = 1e-4
DECODE_ATOL = 5e-4             # tests/test_archs_smoke.py


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while the module runs (six test processes
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _two_periods(cfg):
    """Each group's period stacked twice, so remat wraps more than one
    period."""
    groups = tuple((specs, 2) for specs, _ in cfg.groups)
    return dataclasses.replace(cfg, groups=groups,
                               n_layers=sum(2 * len(s) for s, _ in groups))


def _close_leaves(got_tree, want_tree, *, atol=None, rtol=None):
    got = TT.leaves(got_tree)
    want = [np.asarray(w) for w in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        tol = atol if atol is not None else rtol * max(
            float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol


STEP_CASES = {
    "adamw": dict(archs=("mistral-nemo-12b", "rwkv6-1.6b"), optimizer=None,
                  changes={}),
    "adafactor_remat_m2": dict(archs=("rwkv6-1.6b", "olmoe-1b-7b"),
                               optimizer="adafactor",
                               changes=dict(remat=True,
                                            train_microbatches=2)),
}


@pytest.mark.parametrize("case, arch", [(c, a) for c, v in STEP_CASES.items()
                                        for a in v["archs"]])
def test_train_step_matches_reference(case, arch):
    spec = STEP_CASES[case]
    jcfg, cfg = cfgs(arch, **spec["changes"])
    if spec["changes"]:
        jcfg, cfg = _two_periods(jcfg), _two_periods(cfg)
    jp, params = init(jcfg)
    nb = batch(cfg, seed=3, B=4)
    jstep, jinit = JTR.make_train_step(jcfg, optimizer=spec["optimizer"])
    jnew, jopt, jm = jax.jit(jstep)(jp, jinit(jp), as_jax(nb))
    step, opt_init = TR.make_train_step(cfg, optimizer=spec["optimizer"])
    fwd0, bwd0 = RW.rwkv6_scan.calls, RW.rwkv6_scan_backward.calls
    new, opt, m = step(params, opt_init(params), as_torch(nb))
    for k in ("loss", "grad_norm"):
        assert m[k].shape == () and m[k].dtype == torch.float32
        assert abs(float(m[k]) - float(jm[k])) <= STEP_ATOL * abs(float(jm[k]))
    _close_leaves(new, jnew, atol=STEP_ATOL)
    _close_leaves({k: v for k, v in opt.items() if k != "step"},
                  {k: v for k, v in jopt.items() if k != "step"},
                  rtol=STATE_RTOL)
    assert int(opt["step"]) == int(jopt["step"]) == 1
    # the caller's tree is untouched
    _close_leaves(params, jp, atol=0.0)
    if arch == "rwkv6-1.6b":
        layers = cfg.n_layers * cfg.train_microbatches
        assert RW.rwkv6_scan_backward.calls - bwd0 == layers
        assert RW.rwkv6_scan.calls - fwd0 == layers * (2 if cfg.remat else 1)


def test_pallas_kernel_raises_under_a_train_step():
    """``kernel="pallas"`` reaches the flash kernel, which has no
    backward: the step raises on the CPU as it would on the card."""
    _, cfg = cfgs("mistral-nemo-12b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    step, opt_init = TR.make_train_step(cfg, kernel="pallas")
    with pytest.raises(RuntimeError, match="no backward"):
        step(params, opt_init(params), as_torch(batch(cfg)))


def test_sharding_hooks_name_item_12():
    """The sharding hooks are ported: on plain (unplaced) tensors the
    policy's ``constrain`` passes every activation through unchanged, and
    ``constrain_grads`` sees the accumulated float32 gradients once a
    step, before the optimizer, so the step's numbers are bit for bit
    the step without hooks. (Placed steps: ``tests/test_torch_dist_*``.)"""
    from repro_torch.distributed.sharding import Policy, abstract_mesh
    _, cfg = cfgs("olmoe-1b-7b")
    pol = Policy(cfg, abstract_mesh((1, 1), ("data", "model")),
                 tuned=True, strategy="fsdp")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    seen = []

    def constrain_grads(grads):
        seen.append(TT.leaves(grads))
        return grads

    plain, opt_init = TR.make_train_step(cfg)
    hooked, _ = TR.make_train_step(cfg, constrain=pol.constrain,
                                   constrain_grads=constrain_grads)
    b = as_torch(batch(cfg))
    want = plain(params, opt_init(params), b)
    got = hooked(params, opt_init(params), b)
    assert len(seen) == 1
    assert all(g.dtype == torch.float32 for g in seen[0])
    assert len(seen[0]) == len(TT.leaves(params))
    assert torch.equal(got[2]["loss"], want[2]["loss"])
    for a, w in zip(TT.leaves(got[0]), TT.leaves(want[0])):
        assert torch.equal(a, w)


# --------------------------------------- tests/test_archs_smoke.py's cases

def _port_model(arch):
    _, cfg = cfgs(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    for gi, (specs, count) in enumerate(cfg.groups):
        for i, spec in enumerate(specs):
            if spec.mixer == "cross_attn":
                params["groups"][str(gi)][str(i)]["gate_attn"].fill_(0.5)
    return cfg, params


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finite(arch):
    cfg, params = _port_model(arch)
    b = as_torch(batch(cfg, seed=1))
    with torch.no_grad():
        logits, extras = T.forward_train(params, cfg, b["tokens"],
                                         cond=b.get("cond"),
                                         next_tokens=b["labels"])
    B, S = b["tokens"].shape[:2]
    want = (B, S, cfg.vocab_size) if cfg.n_codebooks == 1 else \
        (B, S, cfg.n_codebooks, cfg.vocab_size)
    assert logits.shape == want and bool(torch.isfinite(logits).all())
    assert extras["moe_aux"].shape == ()
    if cfg.mtp:
        assert extras["mtp_logits"].shape == want


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_moves_the_parameters(arch):
    cfg, params = _port_model(arch)
    step, opt_init = TR.make_train_step(cfg)
    new, _, m = step(params, opt_init(params), as_torch(batch(cfg, seed=2)))
    assert bool(torch.isfinite(m["loss"])) and bool(
        torch.isfinite(m["grad_norm"]))
    moved = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(TT.leaves(params), TT.leaves(new)))
    assert moved > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward_train(arch):
    cfg, params = _port_model(arch)
    b = as_torch(batch(cfg, seed=4, S=10))
    toks, cond = b["tokens"], b.get("cond")
    S = toks.shape[1]
    with torch.inference_mode():
        full, _ = T.forward_train(params, cfg, toks, cond=cond)
        _, cache = T.prefill(params, cfg, toks[:, :S - 1], cond=cond,
                             cache_len=S + 3)
        ld, _ = T.decode_step(params, cfg, toks[:, S - 1:S], cache, S - 1)
    np.testing.assert_allclose(ld.numpy(), full[:, S - 1:S].numpy(),
                               atol=DECODE_ATOL, rtol=0)


def _adafactor_functional(cfg, grads, state, params):
    """Adafactor's update as the reference writes it: the whole tree
    clipped first, then each leaf's expressions, every one a new tensor."""
    from repro_torch.training import optimizer as OPT
    step = state["step"] + 1
    lr = float(OPT.schedule(cfg, step))
    grads, gnorm = OPT.clip_by_global_norm(grads, cfg.grad_clip)
    beta = float(1.0 - (OPT._f32(step) + 1.0) ** -0.8)

    def upd(p, g, v):
        g2 = g * g + 1e-30
        if OPT._factored(p.shape):
            vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(dim=-1)[..., None, None],
                                   min=1e-30))
            u = g * torch.rsqrt(denom + 1e-30)
            nv = {"vr": vr, "vc": vc}
        else:
            nv_ = beta * v["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(nv_ + 1e-30)
            nv = {"v": nv_}
        rms = torch.sqrt((u * u).mean() + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), nv

    vs = dict(OPT._state_at(params, state["v"]))
    outs = [upd(p, g, vs[path]) for (path, p), g
            in zip(TT.paths(params), TT.leaves(grads))]
    return (TT.unflatten(params, [o[0] for o in outs]),
            {"v": TT.unflatten(params, [o[1] for o in outs]), "step": step},
            gnorm)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_in_groups_gives_the_same_numbers(name, monkeypatch):
    """The update keeps its temporaries bounded at full width, and gives
    the same bits as written without that care: AdamW in groups of at
    most GROUP_ELEMENTS elements against one group of every leaf;
    Adafactor, clipping leaf by leaf and in place, against the functional
    expressions of ``_adafactor_functional``. Two steps each."""
    from repro_torch.training import optimizer as OPT
    g = torch.Generator().manual_seed(5)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 3, 4)}, "e": (40, 9)}
    draw = lambda s: (torch.randn(s, generator=g)  # noqa: E731
                      if isinstance(s, tuple) else
                      {k: draw(v) for k, v in s.items()})
    params, grads = draw(shapes), draw(shapes)
    params["a"] = params["a"].to(torch.bfloat16)
    cfg, init, update = OPT.make_optimizer(name)
    if name == "adamw":
        def runs():
            for cap in (OPT.GROUP_ELEMENTS, 20):
                monkeypatch.setattr(OPT, "GROUP_ELEMENTS", cap)
                yield update
            assert len(list(OPT._groups(TT.leaves(params)))) == 4
    else:
        def runs():
            yield update
            yield lambda *a: _adafactor_functional(cfg, *a)
    outs = []
    for fn in runs():
        state = init(params)
        for _ in range(2):
            new, state, gn = fn(grads, state, params)
        outs.append(TT.leaves((new, state, gn)))
    assert len(outs) == 2 and len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
