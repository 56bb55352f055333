"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's on the CPU.

The first six tests are ``tests/test_moe.py``'s, run on the port's own
init at the same reduced OLMoE config (``tiny_moe_cfg``: d_model 64, 4
experts, top-2). The rest hold ``moe_forward`` to the reference's on the
same weights (drawn in JAX, carried over by ``convert.from_jax_numpy``)
and the same inputs (numpy, fixed seeds), in float32: ``y`` within 1e-5,
the load-balance loss within 1e-6 (both sum the same float32 terms in
another order), and the kept (token, expert) pairs exactly the
reference's at capacity factors that keep every pick, drop some and
drop most.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.models import moe as M

YTOL = 1e-5
AUXTOL = 1e-6


@pytest.fixture(scope="module")
def cfg(tiny_moe_cfg):
    """The port's config, equal to the reference's ``tiny_moe_cfg``."""
    mine = reduced(get_config("olmoe-1b-7b"), d_model=64)
    assert dataclasses.asdict(mine) == dataclasses.asdict(tiny_moe_cfg)
    return mine


def _cfg(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def _x(seed, shape):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _init(cfg, seed=0):
    return M.moe_init(torch.Generator().manual_seed(seed), cfg, device="cpu")


# ------------------------------------------- tests/test_moe.py, on the port

def test_dispatch_matches_dense_ref(cfg):
    cfg = _cfg(cfg, capacity_factor=8.0)   # no drops
    p = _init(cfg)
    x = _x(0, (2, 16, cfg.d_model))
    y, aux = M.moe_forward(p, x, cfg)
    want = M.moe_ref(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-4)
    assert float(aux) > 0


def test_capacity_drops_are_bounded(cfg):
    """With capacity_factor ~0, most contributions are dropped but shared
    experts / shapes stay sane."""
    cfg = _cfg(cfg, capacity_factor=0.01)
    p = _init(cfg)
    x = _x(1, (2, 32, cfg.d_model))
    y, _ = M.moe_forward(p, x, cfg)
    assert y.shape == x.shape
    assert not torch.isnan(y).any()


def test_capacity_rounding(cfg):
    c = M.capacity(128, cfg)
    assert c % 8 == 0 and c >= 8
    assert c >= 128 * cfg.experts_per_tok / cfg.n_experts
    for n in (1, 7, 64, 520, 4096):
        for cf in (0.01, 1.25, 2.0, 8.0):
            assert M.capacity(n, _cfg(cfg, capacity_factor=cf)) == \
                JM.capacity(n, _cfg(cfg, capacity_factor=cf))


def test_aux_loss_uniform_router_is_one(cfg):
    """With a zero router (uniform probs), Switch aux loss == 1."""
    p = _init(cfg)
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = _x(2, (1, 64, cfg.d_model))
    _, aux = M.moe_forward(p, x, cfg)
    assert float(aux) == pytest.approx(1.0, rel=1e-3)


def test_shared_expert_always_active(cfg):
    cfg = _cfg(cfg, n_shared_experts=1, moe_d_ff=max(16, cfg.moe_d_ff))
    p = _init(cfg)
    assert "shared" in p
    x = _x(3, (1, 8, cfg.d_model))
    y, _ = M.moe_forward(p, x, cfg)
    # zeroing routed experts leaves the shared contribution
    p2 = dict(p, gate=torch.zeros_like(p["gate"]), up=torch.zeros_like(p["up"]))
    y2, _ = M.moe_forward(p2, x, cfg)
    assert float(y2.abs().sum()) > 0


def test_grad_flows_through_dispatch(cfg):
    cfg = _cfg(cfg, capacity_factor=4.0)
    p = {k: v.requires_grad_() for k, v in _init(cfg).items()}
    x = _x(4, (1, 16, cfg.d_model))
    y, aux = M.moe_forward(p, x, cfg)
    (torch.sum(y * y) + aux).backward()
    assert float(p["down"].grad.abs().sum()) > 0
    assert float(p["router"].grad.abs().sum()) > 0


# ------------------------------------------------ parity with the reference

def _reference_kept(jp, x, cfg):
    """The (token, expert) pairs the reference's dispatch keeps, by its
    own lines (``repro/models/moe.py:62-77``) on its own top-k."""
    B, S, d = x.shape
    N, E, k = B * S, cfg.n_experts, cfg.experts_per_tok
    probs = jax.nn.softmax(jnp.asarray(x).reshape(N, d) @ jp["router"], -1)
    _, top_i = jax.lax.top_k(probs, k)
    eids = top_i.reshape(N * k)
    order = jnp.argsort(eids)
    se = eids[order]
    st = (jnp.arange(N * k) // k)[order]
    starts = jnp.searchsorted(se, jnp.arange(E, dtype=se.dtype))
    pos = jnp.arange(N * k) - starts[se]
    keep = pos < JM.capacity(N, cfg)
    return {(int(t), int(e)) for t, e, kp in
            zip(np.asarray(st), np.asarray(se), np.asarray(keep)) if kp}


def _port_kept(p, x, cfg):
    N = x.shape[0] * x.shape[1]
    _, _, top_i = M.route(p["router"], x.reshape(N, -1), cfg.experts_per_tok)
    _, se, st, _, keep = M.dispatch(top_i, M.capacity(N, cfg), cfg.n_experts)
    return {(int(t), int(e)) for t, e, kp in zip(st, se, keep) if kp}


def _pair(cfg, seed=0):
    jp = JM.moe_init(jax.random.PRNGKey(seed), cfg)
    return jp, from_jax_numpy(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("capacity_factor, shared, seeds, n_kept", [
    (8.0, 0, (0, 5), 128), (1.25, 0, (1, 11), 127), (0.01, 0, (0, 5), 32),
    (1.25, 1, (1, 11), 127)])
def test_moe_forward_matches_reference(cfg, capacity_factor, shared, seeds,
                                       n_kept):
    """y within 1e-5, aux within 1e-6, and the same kept (token, expert)
    pairs: all 128 picks of 64 tokens at 8.0; 127 at 1.25, where one
    expert draws 41 picks for its 40 slots (the seeds, weights' and
    input's, are the one pair of 28 tried that overflows an expert at
    1.25); 32 at 0.01 (8 slots an expert)."""
    cfg = _cfg(cfg, capacity_factor=capacity_factor, n_shared_experts=shared)
    jp, p = _pair(cfg, seed=seeds[0])
    x = _x(seeds[1], (2, 32, cfg.d_model))
    jy, jaux = JM.moe_forward(jp, jnp.asarray(x.numpy()), cfg)
    y, aux = M.moe_forward(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=YTOL)
    assert abs(float(aux) - float(jaux)) <= AUXTOL
    kept = _port_kept(p, x, cfg)
    assert kept == _reference_kept(jp, x.numpy(), cfg)
    assert len(kept) == n_kept


def test_zero_router_picks_the_reference_experts(cfg):
    """A zero router makes every probability a tie: the port takes the
    lowest expert ids first, as ``jax.lax.top_k`` does, and gives the
    reference's y."""
    jp, p = _pair(cfg, seed=1)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = _x(6, (1, 24, cfg.d_model))
    _, _, top_i = M.route(p["router"], x.reshape(24, -1), cfg.experts_per_tok)
    probs = jax.nn.softmax(jnp.asarray(x.numpy()).reshape(24, -1)
                           @ jp["router"], -1)
    _, jtop_i = jax.lax.top_k(probs, cfg.experts_per_tok)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    assert (top_i.numpy() == np.arange(cfg.experts_per_tok)).all()
    jy, jaux = JM.moe_forward(jp, jnp.asarray(x.numpy()), cfg)
    y, aux = M.moe_forward(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=YTOL)
    assert abs(float(aux) - float(jaux)) <= AUXTOL


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ref_matches_reference(cfg, shared):
    cfg = _cfg(cfg, n_shared_experts=shared)
    jp, p = _pair(cfg, seed=2)
    x = _x(7, (2, 9, cfg.d_model))
    np.testing.assert_allclose(
        M.moe_ref(p, x, cfg).numpy(),
        np.asarray(JM.moe_ref(jp, jnp.asarray(x.numpy()), cfg)), atol=YTOL)


def test_decode_sized_call_matches_reference(cfg):
    """B=1, S=1: one token, the capacity's floor of 8 slots an expert."""
    jp, p = _pair(cfg, seed=3)
    x = _x(8, (1, 1, cfg.d_model))
    jy, jaux = JM.moe_forward(jp, jnp.asarray(x.numpy()), cfg)
    y, aux = M.moe_forward(p, x, cfg)
    assert M.capacity(1, cfg) == 8
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=YTOL)
    assert abs(float(aux) - float(jaux)) <= AUXTOL


def test_moe_tree_converts_leaf_for_leaf(cfg):
    """A bf16 MoE tree with a shared expert: the reference's leaves carry
    over with their keys, shapes and dtypes (the router float32, the
    stacked experts bf16), the layout the port's own init builds."""
    cfg = _cfg(cfg, dtype="bfloat16", n_shared_experts=1)
    jp = JM.moe_init(jax.random.PRNGKey(4), cfg)
    got = from_jax_numpy(jax.device_get(jp), "cpu")
    mine = _init(cfg)
    flat = lambda t: {"/".join(map(str, k)): v for k, v in  # noqa: E731
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    got_f, mine_f, want_f = flat(got), flat(mine), flat(jp)
    assert got_f.keys() == mine_f.keys() == want_f.keys()
    for k, a in got_f.items():
        assert tuple(a.shape) == want_f[k].shape == tuple(mine_f[k].shape)
        assert a.dtype == mine_f[k].dtype
        assert str(a.dtype).split(".")[-1] == str(want_f[k].dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(want_f[k], np.float32))
    assert got["router"].dtype == torch.float32
    assert got["gate"].dtype == torch.bfloat16


def test_expert_parallel_path_names_roadmap_item(cfg):
    """The expert-parallel path is ported (its runs on one, two and four
    ranks are ``tests/test_torch_dist_*.py``); like the reference's it
    needs ``expert_axes`` to be a suffix of ``token_axes``, and refuses
    anything else before it touches the mesh or a process group."""
    from repro_torch.distributed.sharding import abstract_mesh
    p = _init(cfg)
    mesh = abstract_mesh((1, 1), ("data", "model"))
    for token_axes, expert_axes in ((("data", "model"), ("data",)),
                                    (("data",), ("model",)),
                                    (("model",), ("data", "model")),
                                    (("data", "model"), ())):
        with pytest.raises(ValueError, match="suffix"):
            M.moe_forward_a2a(p, _x(9, (1, 4, cfg.d_model)), cfg, mesh=mesh,
                              token_axes=token_axes,
                              expert_axes=expert_axes)
