"""Placed input specs for every (arch x input-shape) combination.

The port of ``repro.launch.specs``. ``input_specs(cfg, shape, policy)``
returns ``(step_fn, args)``: ``step_fn`` is the step a sharded run
calls, ``args`` its inputs as ``meta``-device DTensors placed on
``policy.mesh`` by the policy's specs (the counterpart of a
``ShapeDtypeStruct`` with a ``NamedSharding``: shapes, dtypes and
placements, nothing allocated). ``materialize`` builds the same args
with values on a real mesh (seeded weights or given ones, seeded
tokens, zero optimizer state and cache), so that the step runs.

The optimizer's ``step`` counter stays a plain host int32, as the
port's optimizer keeps it (``training.optimizer``); a decode step's
position ``t`` is a plain 0-d int32.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..configs.base import InputShape, ModelConfig
from ..distributed import sharding as SH
from ..distributed import spmd as SP
from ..distributed.sharding import Policy
from ..models import transformer as T
from ..serving.kv_cache import cache_plan
from ..training import optimizer as OPT
from ..training.trainer import make_train_step


def with_shardings(policy: Policy, pspecs, tree):
    """Each tensor of ``tree`` placed by the spec at the same path of
    ``pspecs`` (host scalars, such as the optimizer's step, stay)."""
    if isinstance(tree, dict):
        return {k: v if k == "step" else with_shardings(policy, pspecs[k], v)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(with_shardings(policy, s, v)
                          for s, v in zip(pspecs, tree))
    return SP.place(tree, policy.mesh, SH.placements(pspecs, policy.mesh))


def abstract_params(cfg: ModelConfig, policy: Policy):
    aparams = SH.abstract_params(cfg, T.init_params)
    return with_shardings(policy, policy.param_pspecs(aparams), aparams)


def _tokens_shape(cfg, B, S):
    return (B, S) if cfg.n_codebooks == 1 else (B, S, cfg.n_codebooks)


def token_batch(cfg: ModelConfig, shape: InputShape, policy: Policy,
                *, labels: bool):
    B, S = shape.global_batch, shape.seq_len
    meta = partial(torch.empty, device="meta")
    batch = {"tokens": meta(_tokens_shape(cfg, B, S), dtype=torch.int32)}
    if labels:
        batch["labels"] = meta(_tokens_shape(cfg, B, S), dtype=torch.int32)
    if cfg.cond_dim:
        batch["cond"] = meta((B, cfg.cond_seq_len, cfg.cond_dim),
                             dtype=torch.bfloat16)
    return with_shardings(policy, policy.batch_pspecs(batch), batch)


def moe_a2a_hook(cfg, policy):
    """The tuned-fsdp expert-parallel dispatch (``moe_a2a``), else None."""
    if not (policy.tuned and policy.strategy == "fsdp" and cfg.n_experts):
        return None
    expert_axes = ("data", "model") if policy.experts_2d else ("model",)
    return {"mesh": policy.mesh, "token_axes": policy.dp,
            "expert_axes": expert_axes}


def moe_pre_hook(cfg, policy):
    """Decode: replicate the (tiny) token activations over the mesh so the
    dispatch against expert-sharded weights needs no exchange."""
    if not (policy.tuned and cfg.n_experts):
        return None

    def moe_pre(h):
        if not SP.is_dtensor(h):
            return h
        return h.redistribute(h.device_mesh,
                              SP.shard_placements(h.device_mesh, ()))
    return moe_pre


def constrain_grads_hook(policy):
    def constrain_grads(grads):
        pspecs = policy.param_pspecs(grads)

        def one(g, spec):
            if not SP.is_dtensor(g):
                return g
            want = SH.placements(spec, g.device_mesh)
            if tuple(g.placements) != want:
                g = g.redistribute(g.device_mesh, want)
            return g
        return zip_specs(one, grads, pspecs)
    return constrain_grads


def zip_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def input_specs(cfg: ModelConfig, shape: InputShape, policy: Policy):
    """Returns (step_fn, args) for ``step_fn(*args)``."""
    params = abstract_params(cfg, policy)

    if shape.kind == "train":
        step, opt_init = make_train_step(
            cfg, constrain=policy.constrain,
            constrain_grads=constrain_grads_hook(policy),
            moe_a2a=moe_a2a_hook(cfg, policy))
        aopt = opt_init(SH.abstract_params(cfg, T.init_params))
        opt = with_shardings(policy, policy.opt_pspecs(params, aopt), aopt)
        batch = token_batch(cfg, shape, policy, labels=True)
        return step, (params, opt, batch)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return T.prefill(params, cfg, batch["tokens"],
                             cond=batch.get("cond"),
                             constrain=policy.constrain)
        batch = token_batch(cfg, shape, policy, labels=False)
        return prefill_step, (params, batch)

    if shape.kind == "decode":
        cache_len, window = cache_plan(cfg, shape)
        long = shape.name == "long_500k"
        moe_pre = moe_pre_hook(cfg, policy)

        def serve_step(params, cache, tokens, t):
            return T.decode_step(params, cfg, tokens, cache, t,
                                 window_attn=window, moe_pre=moe_pre)

        acache = T.init_cache(cfg, shape.global_batch, cache_len,
                              device="meta")
        cache = with_shardings(policy, policy.cache_pspecs(acache,
                                                            long=long),
                                acache)
        tokens = torch.empty(_tokens_shape(cfg, shape.global_batch, 1),
                             dtype=torch.int32, device="meta")
        tokens = with_shardings(policy, policy.batch_spec(tokens), tokens)
        t = torch.zeros((), dtype=torch.int32)
        return serve_step, (params, cache, tokens, t)

    raise ValueError(shape.kind)


def materialize_batch(cfg: ModelConfig, shape: InputShape, policy: Policy,
                      *, seed=0):
    """The placed batch ``materialize`` gives ``shape``: tokens (and, to
    train, labels; cond for a conditioned arch) drawn with numpy from
    ``seed``; a decode shape's one token a row."""
    dev = torch.device(policy.mesh.device_type)
    rng = np.random.default_rng(seed)
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len

    def tokens():
        return torch.from_numpy(rng.integers(
            0, cfg.vocab_size, _tokens_shape(cfg, B, S),
            dtype=np.int32)).to(dev)
    b = {"tokens": tokens()}
    if shape.kind == "train":
        b["labels"] = tokens()
    if cfg.cond_dim and shape.kind != "decode":
        b["cond"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.cond_seq_len, cfg.cond_dim)).astype(np.float32)
        ).to(device=dev, dtype=torch.bfloat16)
    return with_shardings(policy, policy.batch_pspecs(b), b)


def materialize(cfg: ModelConfig, shape: InputShape, policy: Policy, *,
                seed=0, params=None):
    """The args of ``input_specs(cfg, shape, policy)`` with values, on the
    mesh's device: ``params`` (a plain tree, the same on every rank, e.g.
    converted weights) or weights drawn from ``seed`` (a generator on the
    mesh's device), the batch of ``materialize_batch``, zero optimizer
    state and cache; each placed as the specs place it. Every rank must
    pass the same values."""
    dev = torch.device(policy.mesh.device_type)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = T.init_params(cfg, gen, device=dev)
    placed = with_shardings(policy, policy.param_pspecs(params), params)
    batch = materialize_batch(cfg, shape, policy, seed=seed)
    if shape.kind == "train":
        _, opt_init, _ = OPT.make_optimizer(cfg.optimizer)
        opt = opt_init(params)
        opt = with_shardings(policy, policy.opt_pspecs(params, opt), opt)
        return placed, opt, batch
    if shape.kind == "prefill":
        return placed, batch
    if shape.kind == "decode":
        cache_len, _ = cache_plan(cfg, shape)
        cache = T.init_cache(cfg, shape.global_batch, cache_len, device=dev)
        cache = with_shardings(policy, policy.cache_pspecs(
            cache, long=shape.name == "long_500k"), cache)
        return placed, cache, batch["tokens"], torch.zeros(
            (), dtype=torch.int32)
    raise ValueError(shape.kind)
