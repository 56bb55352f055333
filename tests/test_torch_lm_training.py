"""LM training of the LLM zoo, the port against the JAX package on the CPU:
``forward_train`` and the gradients of ``trainer.make_loss_fn``.

Each arch runs reduced in float32 (``configs.reduced``), its weights
from the reference's ``init_params`` converted through
``repro_torch.convert``, Llama-Vision's gates set to 0.5 (at their
initial 0 the cross branch carries no gradient), and a batch of numpy
tokens from a seed (B=2, S=12; MusicGen's (B, S, 4); seeded ``cond`` for
the conditioned two). The reference's side of an arch is computed once
per module (``reference``): ``forward_train`` and
``jax.value_and_grad(make_loss_fn(cfg))``, each under ``jax.jit``.

Tolerances: logits, ``mtp_logits`` and ``moe_aux`` within 1e-5, reduced
Jamba's 16 layers at the whole-model 5e-4 of tests/test_archs_smoke.py
(as tests/test_torch_llm.py holds it); the loss within 1e-5; every
gradient leaf within 1e-4 of that leaf's max |g| (float32 sums in
another order, through up to 16 layers and two cross-entropies).

The ten archs are split over this file and
``test_torch_lm_training_hybrid.py`` (DeepSeek-V3 here, Jamba there, the
two slowest to trace), so that two test processes share the work; the
steps, the reference's smoke cases and the remat and microbatch path are
``test_torch_lm_training_steps.py``'s.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import transformer as JT
from repro.training import trainer as JTR
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.models import transformer as T
from repro_torch.training import trainer as TR
from repro_torch.training import tree as TT

ATOL = 1e-5
WHOLE_MODEL_ATOL = 5e-4        # reduced Jamba, as tests/test_torch_llm.py
GRAD_RTOL = 1e-4               # of each leaf's max |g|
GATE = 0.5
ARCHS = ("deepseek-v3-671b", "mistral-nemo-12b", "rwkv6-1.6b",
         "olmoe-1b-7b", "codeqwen1.5-7b")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while the module runs, as the other heavy
    torch test files do: six test processes share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cfgs(arch, **changes):
    """(reference config, port config), reduced, with ``changes``."""
    import dataclasses
    return (dataclasses.replace(jreduced(jget_config(arch)), **changes),
            dataclasses.replace(reduced(get_config(arch)), **changes))


def open_gates(jp, jcfg):
    """The reference's tree with every ``gate_attn`` set to GATE."""
    for gi, (specs, count) in enumerate(jcfg.groups):
        for i, spec in enumerate(specs):
            if spec.mixer == "cross_attn":
                jp["groups"][str(gi)][str(i)]["gate_attn"] = jnp.full(
                    (count,), GATE, jnp.float32)
    return jp


def init(jcfg, seed=0):
    """(reference params with open gates, the same converted)."""
    jp = open_gates(JT.init_params(jcfg, jax.random.PRNGKey(seed)), jcfg)
    return jp, from_jax_numpy(jax.device_get(jp), "cpu")


def batch(cfg, seed=0, B=2, S=12):
    """numpy {"tokens", "labels"[, "cond"]}: (B, S+1[, ncb]) tokens split
    as the launcher splits them, cond ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    extra = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1) + extra).astype(
        np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.cond_dim:
        out["cond"] = rng.normal(size=(B, cfg.cond_seq_len, cfg.cond_dim)
                                 ).astype(np.float32)
    return out


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def atol(cfg):
    return WHOLE_MODEL_ATOL if cfg.arch_type == "hybrid" else ATOL


@functools.lru_cache(maxsize=None)
def reference(arch):
    """Everything both sides need for ``arch``, the reference's results
    computed once: configs, params, the batch, its forward_train and its
    value_and_grad."""
    jcfg, cfg = cfgs(arch)
    jp, params = init(jcfg)
    nb = batch(cfg)
    jb = as_jax(nb)
    fwd = jax.jit(lambda p, b: JT.forward_train(
        p, jcfg, b["tokens"], cond=b.get("cond"), next_tokens=b["labels"]))
    logits, extras = fwd(jp, jb)
    loss, grads = jax.jit(jax.value_and_grad(JTR.make_loss_fn(jcfg)))(jp, jb)
    return dict(jcfg=jcfg, cfg=cfg, params=params, batch=nb,
                logits=np.asarray(logits),
                extras={k: np.asarray(v) for k, v in extras.items()},
                loss=float(loss),
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)])


def check_forward(arch):
    ref = reference(arch)
    cfg, b = ref["cfg"], as_torch(ref["batch"])
    with torch.no_grad():
        logits, extras = T.forward_train(ref["params"], cfg, b["tokens"],
                                         cond=b.get("cond"),
                                         next_tokens=b["labels"])
    tol = atol(cfg)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=tol,
                               rtol=0)
    assert sorted(extras) == sorted(ref["extras"])
    assert ("mtp_logits" in extras) == bool(cfg.mtp)
    for k, v in extras.items():
        np.testing.assert_allclose(v.numpy(), ref["extras"][k], atol=tol,
                                   rtol=0)


def check_grads(arch):
    ref = reference(arch)
    cfg = ref["cfg"]
    loss, grads = TR.value_and_grad(TR.make_loss_fn(cfg), ref["params"],
                                    as_torch(ref["batch"]))
    assert abs(float(loss) - ref["loss"]) <= ATOL
    paths = [p for p, _ in TT.paths(ref["params"])]
    assert len(grads) == len(ref["grads"]) == len(paths)
    for path, g, want in zip(paths, grads, ref["grads"]):
        assert g.shape == want.shape, path
        scale = float(np.abs(want).max())
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_RTOL * scale, (path, err, scale)
    # every leaf carries a gradient (Llama-Vision's gates are open)
    assert all(float(np.abs(w).max()) > 0 for w in ref["grads"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch):
    check_grads(arch)
