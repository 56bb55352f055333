"""The port's sharded steps on a one-rank gloo mesh, in this process,
against the JAX reference on its 1x1 host mesh.

Mirrors ``tests/test_distributed_perf.py::test_a2a_single_device_matches_
ref`` and ``test_a2a_grads_flow``, ``tests/test_sharding_serving.py::
test_host_mesh_constrain_runs`` and ``tests/test_system.py::
test_lowering_on_host_mesh``: the same numpy-seeded weights and inputs go
through both packages. ``moe_forward_a2a`` on the (1, 1) mesh equals the
reference's dense ``moe_ref`` within 1e-5 (float32; the reference's own
tolerance) and its gradients (``gate``, ``router``, every leaf) equal
the reference's a2a gradients within 1e-5 of each leaf's max |g|.
``launch.specs.input_specs`` for reduced OLMoE-1B-7B at the reference's
decode shape (seq 64, batch 2) and at a prefill and a train shape gives
meta DTensors placed by the policy; ``materialize`` fills them with the
reference's weights converted, and each step runs to a finite result
held to the reference's jitted step: logits within 1e-5
(``tests/test_torch_llm.py``'s tolerance), the train step's loss and
grad norm within 1e-5 relative and every parameter within 1e-5
(``tests/test_torch_lm_training_steps.py``'s). Placed steps count their
kernel calls as the unplaced ones do, and no kernel wrapper takes a
DTensor.

The process group is started by the module's fixture only if none is
running, and destroyed by it; the file's last test checks that none is
left.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import SHAPES as JSHAPES
from repro.distributed.sharding import Policy as JPolicy
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.launch.specs import input_specs as jinput_specs
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import SHAPES
from repro_torch.convert import from_jax_numpy
from repro_torch.distributed import spmd as SP
from repro_torch.distributed.sharding import Policy
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as MESH
from repro_torch.launch import specs as SPECS
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.training import trainer as TR
from repro_torch.training import tree as TT

ATOL = 1e-5
GRAD_RTOL = 1e-5
STEP_RTOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    made = not dist.is_initialized()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    m = MESH.make_host_mesh("cpu")
    yield m
    torch.set_num_threads(n)
    if made:
        MESH.close_mesh()
        assert not dist.is_initialized()


# --------------------------------------------------------------- a2a MoE

def _a2a_case():
    """(reference cfg, port cfg, numpy weights, numpy x): reduced OLMoE
    with 4 experts, top-2, capacity factor 8 (nothing dropped)."""
    change = dict(n_experts=4, experts_per_tok=2, capacity_factor=8.0)
    jcfg = dataclasses.replace(jreduced(jget_config("olmoe-1b-7b")), **change)
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")), **change)
    rng = np.random.default_rng(0)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = {"router": f(d, E) / np.sqrt(d), "gate": f(E, d, ff) / np.sqrt(d),
         "up": f(E, d, ff) / np.sqrt(d), "down": f(E, ff, d) / np.sqrt(ff)}
    return jcfg, cfg, {k: v.astype(np.float32) for k, v in p.items()}, \
        f(4, 16, d)


def _jmesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


A2A = dict(token_axes=("data", "model"), expert_axes=("model",),
           pair_capacity_factor=8.0)


def test_a2a_single_device_matches_ref(mesh):
    """On a 1x1 mesh the a2a path degenerates to the dense reference."""
    jcfg, cfg, p, x = _a2a_case()
    want = np.asarray(JM.moe_ref({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), jcfg))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y, aux = M.moe_forward_a2a(tp, torch.from_numpy(x), cfg, mesh=mesh, **A2A)
    assert not SP.is_dtensor(y) and y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), want, atol=ATOL)
    assert float(aux) > 0
    # a placed x gives a placed y, the same rows
    xd = SP.place(torch.from_numpy(x), mesh, SP.shard_placements(
        mesh, ("data", "model")))
    yd, aux2 = M.moe_forward_a2a(tp, xd, cfg, mesh=mesh, **A2A)
    assert SP.is_dtensor(yd)
    np.testing.assert_allclose(yd.to_local().numpy(), want, atol=ATOL)
    assert float(aux2) == float(aux)


def test_a2a_grads_flow(mesh):
    """Gradients reach ``gate`` and ``router`` through both exchanges,
    leaf for leaf the reference's a2a gradients."""
    jcfg, cfg, p, x = _a2a_case()
    jm = _jmesh()

    def jloss(p):
        y, aux = JM.moe_forward_a2a(p, jnp.asarray(x), jcfg, mesh=jm, **A2A)
        return jnp.sum(y * y) + aux

    with jm:
        jg = jax.jit(jax.grad(jloss))({k: jnp.asarray(v)
                                       for k, v in p.items()})
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    y, aux = M.moe_forward_a2a(tp, torch.from_numpy(x), cfg, mesh=mesh, **A2A)
    ((y * y).sum() + aux).backward()
    assert float(tp["gate"].grad.abs().sum()) > 0
    assert float(tp["router"].grad.abs().sum()) > 0
    for k, v in tp.items():
        want = np.asarray(jg[k])
        scale = float(np.abs(want).max())
        assert float(np.abs(v.grad.numpy() - want).max()) <= GRAD_RTOL * scale


# ------------------------------------------------------------ constrain

def test_host_mesh_constrain_runs(mesh):
    cfg = reduced(get_config("mistral-nemo-12b"))
    pol = Policy(cfg, mesh)
    x = torch.zeros((2, 4, cfg.d_model))
    assert pol.constrain(x) is x             # not a DTensor: unchanged
    xd = SP.place(x, mesh, SP.shard_placements(mesh, ()))
    y = pol.constrain(xd)
    assert y.shape == x.shape
    assert tuple(y.placements) == SP.shard_placements(mesh, ("data",))
    assert pol.dp_size() == 1


def test_make_host_mesh_is_one_by_one(mesh):
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        MESH.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        MESH.make_production_mesh(multi_pod=True, device="cpu")


# ------------------------------------------- input_specs on the host mesh

def _olmoe():
    jcfg = jreduced(jget_config("olmoe-1b-7b"))
    cfg = reduced(get_config("olmoe-1b-7b"))
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, from_jax_numpy(jax.device_get(jp), "cpu")


def _placements(tree):
    return [(tuple(a.shape), a.dtype, tuple(a.placements))
            if SP.is_dtensor(a) else (tuple(a.shape), a.dtype, None)
            for a in TT.leaves(tree)]


def _shape(kind):
    name = {"decode": "decode_32k", "prefill": "prefill_32k",
            "train": "train_4k"}[kind]
    seq, batch = (64, 2) if kind == "decode" else (16, 4)
    return (dataclasses.replace(JSHAPES[name], seq_len=seq,
                                global_batch=batch),
            dataclasses.replace(SHAPES[name], seq_len=seq,
                                global_batch=batch))


def _jax_step(jcfg, jpol, jshape, jargs):
    fn, _ = jinput_specs(jcfg, jshape, jpol)
    with jpol.mesh:
        return jax.jit(fn)(*jargs)


@pytest.mark.parametrize("kind", ("decode", "prefill", "train"))
def test_lowering_on_host_mesh(mesh, kind):
    """input_specs for reduced OLMoE on the 1x1 mesh: meta DTensors placed
    by the policy, filled by ``materialize`` (the same placements), and
    the step runs to a finite result equal to the reference's."""
    jcfg, cfg, jp, params = _olmoe()
    jshape, shape = _shape(kind)
    tuned = dict(tuned=True, strategy="fsdp") if kind == "train" else {}
    jpol, pol = JPolicy(jcfg, jmake_host_mesh(), **tuned), \
        Policy(cfg, mesh, **tuned)
    fn, args = SPECS.input_specs(cfg, shape, pol)
    assert all(a.is_meta for a in TT.leaves(args[0]))
    real = SPECS.materialize(cfg, shape, pol, params=params)
    assert _placements(args) == _placements(real)
    whole = lambda a: (a.full_tensor() if SP.is_dtensor(a) else a).numpy()
    if kind == "decode":
        logits, cache = fn(*real)
        want, _ = _jax_step(jcfg, jpol, jshape, (
            jp, JT.init_cache(jcfg, 2, 64), jnp.asarray(whole(real[2])),
            jnp.int32(0)))
    elif kind == "prefill":
        logits, cache = fn(*real)
        assert all(SP.is_dtensor(a) for a in TT.leaves(cache))
        want, _ = _jax_step(jcfg, jpol, jshape, (
            jp, {"tokens": jnp.asarray(whole(real[1]["tokens"]))}))
    else:
        new, opt, m = fn(*real)
        jb = {k: jnp.asarray(whole(v)) for k, v in real[2].items()}
        jnew, jopt, jm = _jax_step(jcfg, jpol, jshape, (
            jp, _jax_opt_init(jcfg, jp), jb))
        for k in ("loss", "grad_norm"):
            assert np.isfinite(float(m[k]))
            assert abs(float(m[k]) - float(jm[k])) <= STEP_RTOL * abs(
                float(jm[k]))
        for a, w in zip(TT.leaves(new), jax.tree.leaves(jnew)):
            assert SP.is_dtensor(a)
            assert float(np.abs(whole(a).astype(np.float32)
                                - np.asarray(w, np.float32)).max()) <= ATOL
        return
    got = whole(logits)
    assert np.isfinite(got).all() and got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def _jax_opt_init(jcfg, jp):
    from repro.training import optimizer as JOPT
    return JOPT.make_optimizer(jcfg.optimizer)[1](jp)


# ----------------------------------------------- kernels see local blocks

def test_kernel_wrappers_refuse_a_dtensor(mesh):
    q = SP.place(torch.zeros((1, 4, 2, 8)), mesh, SP.shard_placements(
        mesh, ()))
    with pytest.raises(TypeError, match="DTensor"):
        kops.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="DTensor"):
        kops.quantize_rowwise(q.reshape(4, 16))


def _calls():
    from repro_torch.kernels import ops
    return {f.__name__: f.calls for f, _ in ops.COUNTERS[::2]}


@pytest.mark.parametrize("arch, kind", [("mistral-nemo-12b", "serve"),
                                        ("rwkv6-1.6b", "serve"),
                                        ("rwkv6-1.6b", "train")])
def test_placed_steps_count_kernel_calls_as_unplaced(mesh, arch, kind):
    """A placed prefill (``kernel="pallas"``) and decode step, and a placed
    train step, call each kernel wrapper as often as the unplaced ones,
    each call on local blocks."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    pol = Policy(cfg, mesh)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))

    def run(placed):
        p = SPECS.with_shardings(pol, pol.param_pspecs(params), params) \
            if placed else params
        t = SP.place(toks, mesh, SP.shard_placements(mesh, ("data",))) \
            if placed else toks
        before = _calls()
        if kind == "serve":
            with torch.no_grad():
                lg, cache = T.prefill(p, cfg, t, cache_len=16,
                                      kernel="pallas",
                                      constrain=pol.constrain)
                nxt = lg.argmax(-1)
                lg, _ = T.decode_step(p, cfg, nxt, cache, 8)
            out = lg
        else:
            b = {"tokens": t, "labels": t}
            out, _ = TR.value_and_grad(TR.make_loss_fn(
                cfg, constrain=pol.constrain), p, b)
        after = _calls()
        return ({k: after[k] - before[k] for k in after},
                out.full_tensor() if SP.is_dtensor(out) else out)

    want_calls, want = run(False)
    got_calls, got = run(True)
    assert got_calls == want_calls
    assert sum(want_calls.values()) > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_no_process_group_is_left(mesh):
    """Last in the file: the fixture's group is destroyed, none is left."""
    MESH.close_mesh()
    assert not dist.is_initialized()
