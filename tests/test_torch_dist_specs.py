"""The port's sharding policy (``repro_torch.distributed.sharding``)
against the reference's, with no process group.

Every spec is a plain tuple on both sides (a JAX ``PartitionSpec`` read
with ``tuple``), compared leaf for leaf at the same key path, for every
arch of the registry on the meshes (4, 2), (16, 16) and (2, 16, 16),
built by each package's own ``abstract_mesh``, under the "2d" and
"fsdp" strategies, tuned and not: ``param_pspecs``, ``opt_pspecs``
under AdamW and Adafactor, ``cache_pspecs`` (``long`` and not) and
``batch_pspecs``. The reference's shapes come from ``jax.eval_shape``,
the port's from its ``meta``-device trees (``abstract_params``), which
must agree shape for shape. The rest mirrors
``tests/test_sharding_serving.py``'s and ``tests/test_distributed_perf
.py``'s policy cases on the port, and checks that ``shardings`` puts
every named axis on the dim its spec names.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.training import tree as TT

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
POLICIES = [("2d", False), ("2d", True), ("fsdp", False), ("fsdp", True)]
# cache and batch shapes: 32 divides the batch axes of every mesh but the
# 512 of 'fsdp' on 2x16x16, 64 positions divide 16 but not 32 or 512
CACHE_B, CACHE_LEN, SEQ = 32, 64, 64
CASES = [(a, m, s, t) for a in ARCHS for m in MESHES for s, t in POLICIES]


def _names(path):
    return tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _ref_specs(tree):
    """{key path: spec tuple} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {_names(p): tuple(s) for p, s in flat}


def _port_specs(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (str(k),))
        elif isinstance(t, list) or (isinstance(t, tuple)
                                     and not SH._is_spec(t)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            out[path] = t
    walk(tree, ())
    return out


def _shapes(tree, ref):
    """{key path: shape} of a reference (eval_shape) or port (meta) tree."""
    if ref:
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {_names(p): tuple(x.shape) for p, x in flat}
    return {tuple(str(k) for k in p): tuple(x.shape)
            for p, x in TT.paths(tree)}


@functools.lru_cache(maxsize=None)
def trees(arch):
    """(reference shape trees, port meta trees) of one arch: params,
    AdamW and Adafactor state, the decode cache and a train batch."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jp = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                        jax.random.PRNGKey(0))
    ref = {"params": jp,
           "adamw": jax.eval_shape(JOPT.make_optimizer("adamw")[1], jp),
           "adafactor": jax.eval_shape(JOPT.make_optimizer("adafactor")[1],
                                       jp),
           "cache": jax.eval_shape(lambda: JT.init_cache(
               jcfg, CACHE_B, CACHE_LEN, jnp.bfloat16))}
    p = SH.abstract_params(cfg, T.init_params)
    mine = {"params": p,
            "adamw": OPT.make_optimizer("adamw")[1](p),
            "adafactor": OPT.make_optimizer("adafactor")[1](p),
            "cache": T.init_cache(cfg, CACHE_B, CACHE_LEN, torch.bfloat16,
                                  device="meta")}
    tshape = (CACHE_B, SEQ) if cfg.n_codebooks == 1 else (
        CACHE_B, SEQ, cfg.n_codebooks)
    ref["batch"] = {"tokens": jax.ShapeDtypeStruct(tshape, jnp.int32),
                    "labels": jax.ShapeDtypeStruct(tshape, jnp.int32)}
    mine["batch"] = {k: torch.empty(tshape, dtype=torch.int32,
                                    device="meta")
                     for k in ("tokens", "labels")}
    if cfg.cond_dim:
        cshape = (CACHE_B, cfg.cond_seq_len, cfg.cond_dim)
        ref["batch"]["cond"] = jax.ShapeDtypeStruct(cshape, jnp.bfloat16)
        mine["batch"]["cond"] = torch.empty(cshape, dtype=torch.bfloat16,
                                            device="meta")
    return jcfg, cfg, ref, mine


def policies(arch, mesh, strategy, tuned):
    shape, axes = MESHES[mesh]
    jcfg, cfg, _, _ = trees(arch)
    return (JSH.Policy(jcfg, JSH.abstract_mesh(shape, axes), tuned=tuned,
                       strategy=strategy),
            SH.Policy(cfg, SH.abstract_mesh(shape, axes), tuned=tuned,
                      strategy=strategy))


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trees_have_the_reference_shapes(arch):
    """``abstract_params`` builds the whole tree on ``meta`` (nothing
    drawn, nothing allocated), shape for shape the reference's
    ``eval_shape``; so do the optimizer states and the cache."""
    _, _, ref, mine = trees(arch)
    for k in ref:
        assert _shapes(mine[k], False) == _shapes(ref[k], True), k
    assert all(x.is_meta for x in TT.leaves(mine["params"]))


@pytest.mark.parametrize("arch, mesh, strategy, tuned", CASES)
def test_param_and_opt_pspecs_match_reference(arch, mesh, strategy, tuned):
    _, _, ref, mine = trees(arch)
    jpol, pol = policies(arch, mesh, strategy, tuned)
    assert pol.dp == jpol.dp and pol.dp_size() == jpol.dp_size()
    assert pol.experts_2d == bool(jpol.experts_2d)
    want = _ref_specs(jpol.param_pspecs(ref["params"]))
    assert _port_specs(pol.param_pspecs(mine["params"])) == want
    for opt in ("adamw", "adafactor"):
        want = _ref_specs(jpol.opt_pspecs(ref["params"], ref[opt]))
        got = _port_specs(pol.opt_pspecs(mine["params"], mine[opt]))
        assert got == want, opt


@pytest.mark.parametrize("arch, mesh, strategy, tuned", CASES)
def test_cache_and_batch_pspecs_match_reference(arch, mesh, strategy, tuned):
    _, _, ref, mine = trees(arch)
    jpol, pol = policies(arch, mesh, strategy, tuned)
    for long in (False, True):
        want = _ref_specs(jpol.cache_pspecs(ref["cache"], long=long))
        assert _port_specs(pol.cache_pspecs(mine["cache"], long=long)) \
            == want, long
    assert _port_specs(pol.batch_pspecs(mine["batch"])) == _ref_specs(
        jpol.batch_pspecs(ref["batch"]))
    tok = mine["batch"]["tokens"]
    assert pol.batch_spec(tok) == tuple(jpol.batch_spec(
        ref["batch"]["tokens"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_shard_each_named_axis_on_its_dim(arch):
    """``shardings``: an axis named at dim d of a spec is ``Shard(d)``,
    every other axis ``Replicate()``; ('data', 'model') on one dim is
    Shard(d) twice, 'data' first (split data-major)."""
    from torch.distributed.tensor import Replicate, Shard
    _, _, _, mine = trees(arch)
    for mesh in MESHES:
        pol = policies(arch, mesh, "fsdp", True)[1]
        specs = pol.param_pspecs(mine["params"])
        places = pol.shardings(specs)
        for path, spec in _port_specs(specs).items():
            pl = places
            for k in path:
                pl = pl[k] if isinstance(pl, dict) else pl[int(k)]
            assert len(pl) == len(pol.mesh.axis_names)
            for ax, p in zip(pol.mesh.axis_names, pl):
                dims = [d for d, a in enumerate(spec) if a == ax or (
                    isinstance(a, tuple) and ax in a)]
                assert p == (Shard(dims[0]) if dims else Replicate())
    mesh = SH.abstract_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="order"):
        SH.placements((("model", "data"), None), mesh)
    with pytest.raises(ValueError, match="twice"):
        SH.placements((("data", "model"), "model"), mesh)


# ------------------------------ tests/test_sharding_serving.py, on the port

def _port(arch, mesh="4x2", **kw):
    cfg = get_config(arch)
    shape, axes = MESHES[mesh]
    return cfg, SH.Policy(cfg, SH.abstract_mesh(shape, axes), **kw), \
        trees(arch)[3]["params"]


def test_param_pspecs_cover_tree():
    _, pol, p = _port("mistral-nemo-12b")
    specs = _port_specs(pol.param_pspecs(p))
    assert len(specs) == len(TT.leaves(p))
    assert all(SH._is_spec(s) for s in specs.values())


@pytest.mark.parametrize("arch", ("qwen1.5-32b", "deepseek-v3-671b",
                                  "olmoe-1b-7b"))
def test_param_specs_divisible(arch):
    """Every sharded dim divides by its mesh axes (the _fit guarantee)."""
    _, pol, p = _port(arch, "16x16")
    specs = _port_specs(pol.param_pspecs(p))
    for path, leaf in TT.paths(p):
        for dim, ax in zip(leaf.shape, specs[tuple(map(str, path))]):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            assert dim % int(np.prod([pol.sizes[a] for a in axes])) == 0


def test_norms_replicated():
    _, pol, p = _port("mistral-nemo-12b")
    s = pol.param_pspecs(p)["final_norm"]["scale"]
    assert all(a is None for a in s)


def test_cache_specs_long_vs_batch():
    cfg = get_config("mistral-nemo-12b")
    pol = SH.Policy(cfg, SH.abstract_mesh((4, 2), ("data", "model")))
    cache = T.init_cache(cfg, 8, 64, torch.bfloat16, device="meta")
    kb = pol.cache_pspecs(cache, long=False)["0"]["0"]["kv"]["k"]
    kl = pol.cache_pspecs(cache, long=True)["0"]["0"]["kv"]["k"]
    assert kb[1] is not None and kb[2] is None      # batch sharded
    assert kl[1] is None and kl[2] is not None      # seq sharded


# ---------------------------- tests/test_distributed_perf.py, on the port

def test_fsdp_strategy_drops_tensor_parallel():
    _, pol, p = _port("mistral-nemo-12b", "16x16", tuned=True,
                      strategy="fsdp")
    for s in _port_specs(pol.param_pspecs(p)).values():
        for a in s:
            assert a is None or a == ("data", "model"), s
    assert pol.dp == ("data", "model")


def test_fsdp_strategy_keeps_expert_dim():
    _, pol, p = _port("deepseek-v3-671b", "16x16", tuned=True,
                      strategy="fsdp")
    assert pol.experts_2d
    gate = pol.param_pspecs(p)["groups"]["1"]["0"]["mlp"]["gate"]
    assert gate == (None, ("data", "model"), None, None)


def test_tuned_head_aware_sharding():
    """kv=8 heads can't shard over model=16: tuned policy replicates."""
    _, base, p = _port("mistral-nemo-12b", "16x16")
    _, tuned, _ = _port("mistral-nemo-12b", "16x16", tuned=True)
    wk = lambda pol: pol.param_pspecs(p)["groups"]["0"]["0"]["mixer"]["wk"]["w"]
    assert wk(base)[-1] == "model"       # flat-divisible, head-splitting
    assert wk(tuned)[-1] is None         # head-aware: replicated
