"""The port's sharded paths on two and four spawned CPU ranks (gloo),
against the JAX reference and the port's unsharded step.

- ``moe_forward_a2a`` on meshes (1, 2) and (2, 2), tokens split over
  ('data', 'model'), experts over 'model' (and, on (2, 2), over both
  axes). With ``pair_capacity_factor`` 8 nothing is dropped: each rank's
  rows equal the reference's dense ``moe_ref`` rows within 1e-5
  (float32, the reference's a2a tolerance) and ``aux`` is the same on
  every rank. With 0.25 tokens are dropped: the rows equal the
  reference's own ``moe_forward_a2a`` on a 4-device host mesh (run in a
  subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
  set before ``jax`` is imported) within 1e-5, and ``aux`` within 1e-6.
- One float32 training step of reduced OLMoE-1B-7B (tuned 'fsdp': the
  ``moe_a2a`` hook, experts over both axes; 4 microbatches of 2 rows,
  which do not split over its 4 batch ranks and run replicated) and of
  reduced Mistral-NeMo ('2d', 2 microbatches) on (2, 2), with remat,
  built from ``launch.specs``' hooks and placed args:
  the loss within rtol 1e-4 of the port's unsharded step on the same
  weights and batch, and every accumulated gradient leaf (as
  ``constrain_grads`` sees it) within 1e-4 of the leaf's max |g| (the
  ``lm_train`` tolerances of PERF.md §2: the ranks sum in another
  order). The unsharded step is held to ``jax.value_and_grad`` by
  ``tests/test_torch_lm_training*.py``.

Each spawned group rendezvouses through a gloo ``FileStore`` under
``tmp_path`` and joins with a deadline of ``DEADLINE`` seconds: past it
the children are killed and the test fails. Workers use one intra-op
thread each.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

DEADLINE = 120
ATOL = 1e-5
AUX_ATOL = 1e-6
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
NO_DROP, DROP = 8.0, 0.25
# (mesh shape, expert axes) of the a2a cases; tokens over both axes
A2A_CASES = {"1x2": ((1, 2), ("model",)), "2x2": ((2, 2), ("model",)),
             "2x2-2d": ((2, 2), ("data", "model"))}
# (policy, config changes): OLMoE's 4 microbatches of 2 rows do not split
# over its 4 batch ranks (each microbatch replicated), Mistral's 2 of 4
# rows split over its 2
TRAIN_CASES = {"olmoe-1b-7b": (dict(tuned=True, strategy="fsdp"),
                               dict(train_microbatches=4)),
               "mistral-nemo-12b": (dict(tuned=False, strategy="2d"),
                                    dict(train_microbatches=2))}
TRAIN_B, TRAIN_S = 8, 16
ROOT = Path(__file__).resolve().parents[1]


def a2a_inputs():
    """(config changes, numpy weights, numpy x): 4 experts, top-2, width
    64, 64 tokens (8 x 8)."""
    changes = dict(n_experts=4, experts_per_tok=2, d_model=64, moe_d_ff=32,
                   capacity_factor=8.0)
    rng = np.random.default_rng(7)
    d, E, ff = 64, 4, 32
    f = lambda *s, sc: (rng.standard_normal(s) * sc).astype(np.float32)
    p = {"router": f(d, E, sc=d ** -0.5), "gate": f(E, d, ff, sc=d ** -0.5),
         "up": f(E, d, ff, sc=d ** -0.5), "down": f(E, ff, d, sc=ff ** -0.5)}
    return changes, p, f(8, 8, d, sc=1.0)


# ------------------------------------------------------------- workers

def _a2a_task(mesh, shape):
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import spmd as SP
    from repro_torch.models import moe as M
    changes, p, x = a2a_inputs()
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")), **changes)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xd = SP.place(torch.from_numpy(x), mesh,
                  SP.shard_placements(mesh, ("data", "model")))
    out = {}
    for name, (mshape, experts) in A2A_CASES.items():
        if mshape != shape:
            continue
        for pcf in (NO_DROP, DROP):
            y, aux = M.moe_forward_a2a(tp, xd, cfg, mesh=mesh,
                                       token_axes=("data", "model"),
                                       expert_axes=experts,
                                       pair_capacity_factor=pcf)
            out[(name, pcf)] = (y.to_local().numpy(), float(aux))
    return out


def _train_task(mesh, rank):
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import spmd as SP
    from repro_torch.distributed.sharding import Policy
    from repro_torch.launch import specs as SPECS
    from repro_torch.models import transformer as T
    from repro_torch.training import trainer as TR
    from repro_torch.training import tree as TT
    out = {}
    for arch, (kw, changes) in TRAIN_CASES.items():
        cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
        if cfg.n_experts:       # no token dropped by either dispatch
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        pol = Policy(cfg, mesh, **kw)
        shape = InputShape("train", TRAIN_S, TRAIN_B, "train")
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        fn, args = SPECS.input_specs(cfg, shape, pol)
        real = SPECS.materialize(cfg, shape, pol, params=params)
        seen = {}
        hook = SPECS.constrain_grads_hook(pol)

        def capture(grads, seen=seen, hook=hook):
            grads = hook(grads)
            seen["g"] = [g.full_tensor() for g in TT.leaves(grads)]
            return grads

        step, _ = TR.make_train_step(
            cfg, constrain=pol.constrain, constrain_grads=capture,
            moe_a2a=SPECS.moe_a2a_hook(cfg, pol))
        new, _, m = step(*real)
        # the specs' own step: the same numbers
        _, _, m2 = fn(*SPECS.materialize(cfg, shape, pol, params=params))
        batch = {k: v.full_tensor() for k, v in real[2].items()}
        placed = [SP.is_dtensor(a) for a in TT.leaves(new)]
        res = {"loss": float(m["loss"]), "specs_loss": float(m2["loss"]),
               "grads": [g.numpy() for g in seen["g"]], "placed": placed,
               "a2a": SPECS.moe_a2a_hook(cfg, pol) is not None}
        if rank == 0:
            want = {}

            def plain_capture(grads, want=want):
                want["g"] = [g.clone() for g in TT.leaves(grads)]
                return grads
            pstep, popt = TR.make_train_step(cfg,
                                             constrain_grads=plain_capture)
            _, _, pm = pstep(params, popt(params), batch)
            res["want_loss"] = float(pm["loss"])
            res["want_grads"] = [g.numpy() for g in want["g"]]
        out[arch] = res
    return out


def _worker(rank, world, shape, store, out_dir, tasks):
    import logging
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        res = {}
        if "a2a" in tasks:
            res["a2a"] = _a2a_task(mesh, shape)
        if "train" in tasks:
            res["train"] = _train_task(mesh, rank)
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(world, shape, tasks, tmp):
    """Run ``_worker`` on ``world`` spawned ranks; the per-rank results.
    Fails (after killing every child) past DEADLINE seconds."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = tmp / f"out{world}"
    out.mkdir()
    store = str(tmp / f"store{world}")
    procs = [ctx.Process(target=_worker, args=(r, world, shape, store,
                                                str(out), tasks))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out


def _join(procs, out, start):
    try:
        for p in procs:
            p.join(max(0.0, start + DEADLINE - time.monotonic()))
        if any(p.is_alive() for p in procs):
            pytest.fail(f"spawned ranks still running after {DEADLINE} s")
        codes = [p.exitcode for p in procs]
        assert codes == [0] * len(procs), f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


# ------------------------------------------------- the reference's side

def _jax_main(out):
    """In a subprocess with 4 host devices: the reference's ``moe_ref``
    and its ``moe_forward_a2a`` for every a2a case."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_config, reduced
    from repro.models import moe as JM
    changes, p, x = a2a_inputs()
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")), **changes)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    res = {"ref": np.asarray(JM.moe_ref(jp, jnp.asarray(x), cfg))}
    for name, (shape, experts) in A2A_CASES.items():
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        for pcf in (NO_DROP, DROP):
            with mesh:
                y, aux = jax.jit(lambda p, x, pcf=pcf: JM.moe_forward_a2a(
                    p, x, cfg, mesh=mesh, token_axes=("data", "model"),
                    expert_axes=experts, pair_capacity_factor=pcf))(
                        jp, jnp.asarray(x))
            res[f"{name}-{pcf}-y"] = np.asarray(y)
            res[f"{name}-{pcf}-aux"] = np.asarray(aux)
    np.savez(out, **res)


def _jax_start(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    out = tmp / "jax.npz"
    code = ("import test_torch_dist_spawn as m, sys; "
            "m._jax_main(sys.argv[1])")
    return subprocess.Popen([sys.executable, "-c", code, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            cwd=str(ROOT)), out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawned groups and the reference's subprocess, concurrently."""
    tmp = tmp_path_factory.mktemp("dist")
    start = time.monotonic()
    jproc, jout = _jax_start(tmp)
    try:
        g2 = _spawn(2, (1, 2), ("a2a",), tmp)
        g4 = _spawn(4, (2, 2), ("a2a", "train"), tmp)
        two = _join(*g2, start)
        four = _join(*g4, start)
        try:
            log, _ = jproc.communicate(
                timeout=max(1.0, start + DEADLINE - time.monotonic()))
        except subprocess.TimeoutExpired:
            pytest.fail(f"reference subprocess running after {DEADLINE} s")
        assert jproc.returncode == 0, log.decode()[-3000:]
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.wait()
    return {"1x2": two, "2x2": four, "jax": dict(np.load(jout))}


def _ranks(runs, name):
    return runs["1x2"] if A2A_CASES[name][0] == (1, 2) else runs["2x2"]


@pytest.mark.parametrize("name", A2A_CASES)
def test_a2a_rows_match_moe_ref_without_drops(runs, name):
    ranks = _ranks(runs, name)
    ref = runs["jax"]["ref"].reshape(-1, runs["jax"]["ref"].shape[-1])
    n = ref.shape[0] // len(ranks)
    auxes = set()
    for r, res in enumerate(ranks):
        y, aux = res["a2a"][(name, NO_DROP)]
        np.testing.assert_allclose(y.reshape(-1, ref.shape[1]),
                                   ref[r * n:(r + 1) * n], atol=ATOL)
        auxes.add(aux)
    assert len(auxes) == 1
    assert abs(auxes.pop() - float(runs["jax"][f"{name}-{NO_DROP}-aux"])) \
        <= AUX_ATOL


@pytest.mark.parametrize("name", A2A_CASES)
def test_a2a_drops_as_the_reference(runs, name):
    ranks = _ranks(runs, name)
    want = runs["jax"][f"{name}-{DROP}-y"]
    want = want.reshape(-1, want.shape[-1])
    ref = runs["jax"]["ref"].reshape(want.shape)
    # tokens were dropped: the reference's own output is not moe_ref's
    assert float(np.abs(want - ref).max()) > 1e-2
    n = want.shape[0] // len(ranks)
    auxes = set()
    for r, res in enumerate(ranks):
        y, aux = res["a2a"][(name, DROP)]
        np.testing.assert_allclose(y.reshape(-1, want.shape[1]),
                                   want[r * n:(r + 1) * n], atol=ATOL)
        auxes.add(aux)
    assert len(auxes) == 1
    assert abs(auxes.pop() - float(runs["jax"][f"{name}-{DROP}-aux"])) \
        <= AUX_ATOL


@pytest.mark.parametrize("arch", TRAIN_CASES)
def test_sharded_train_step_matches_unsharded(runs, arch):
    ranks = [res["train"][arch] for res in runs["2x2"]]
    want = ranks[0]
    assert want["a2a"] == (arch == "olmoe-1b-7b")
    for res in ranks:
        assert all(res["placed"])
        assert res["specs_loss"] == res["loss"]
        assert abs(res["loss"] - want["want_loss"]) <= LOSS_RTOL * abs(
            want["want_loss"])
        assert len(res["grads"]) == len(want["want_grads"])
        for g, w in zip(res["grads"], want["want_grads"]):
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= GRAD_RTOL * scale
