"""Sharding policy: map parameter, cache, batch and optimizer-state trees
to partition specs, and specs to DTensor placements.

The reference's policy (MaxText-style 2D "FSDP + tensor parallel"):
  * mesh axes: ('pod', 'data', 'model') multi-pod, ('data', 'model') single.
  * weights: the tensor-parallel dim (heads / d_ff / experts) shards on
    'model'; when ``cfg.fsdp_weights`` the other big dim shards on
    'data' (ZeRO-3). Weights are never sharded on 'pod'.
  * activations: batch shards on ('pod', 'data') (every axis under the
    'fsdp' strategy).
  * decode caches: batch on the batch axes; for long_500k (batch=1) the
    *sequence* dim of KV/latent buffers shards on them instead.
  * any dim not divisible by its mesh axis falls back to replication.

A spec is a plain tuple with one entry per dim: an axis name, a tuple of
axis names, or None (replicated along that dim). The ``*_pspecs``
methods map the port's nested dicts, lists and tuples of tensors,
walking them with the reference's key paths (dict keys, list indices),
so each leaf gets the spec the reference gives the same leaf.

A mesh is anything with ``axis_names`` and a shape: a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names (``launch.mesh``), ``abstract_mesh(shape, axes)`` (no devices, no
process group: specs at 16x16 or 2x16x16 on one host), or the fleet's
``FleetMesh``. ``placements(spec, mesh)`` turns a spec into DTensor
placements: a mesh axis named in the spec becomes ``Shard(dim)``, any
other ``Replicate()``; a dim sharded over ('data', 'model') is split
'data'-major, as a JAX ``P(('data', 'model'))``.
"""
from __future__ import annotations

NORM_PARENTS = {"norm1", "norm2", "norm_c", "norm_h", "norm_e", "final_norm",
                "q_norm", "kv_norm", "ln_x"}
RWKV_SMALL = {"w0", "mu", "u", "w_lora_a", "w_lora_b"}
COL_PARENTS = {"wq", "wk", "wv", "gate", "up", "wq_b", "wk_b", "wv_b", "in_proj"}
ROW_PARENTS = {"wo", "down", "out_proj"}


def _path_names(path):
    """A key path (dict keys, list indices) as strings."""
    return [str(p) for p in path]


def axis_sizes(mesh):
    """{axis name: size} of a mesh: an ``AbstractMesh``, a ``DeviceMesh``
    (``mesh_dim_names``) or a mesh with a ``devices`` array
    (``fleet.region.FleetMesh``)."""
    sizes = getattr(mesh, "axis_sizes", None)
    if sizes is not None:
        return dict(zip(mesh.axis_names, sizes))
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def axis_names(mesh):
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


class AbstractMesh:
    """A device-free mesh: axis names and sizes only, for building specs
    (the reference's ``jax.sharding.AbstractMesh``)."""

    def __init__(self, shape, axes):
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in length")
        self.axis_names = tuple(axes)
        self.axis_sizes = tuple(int(n) for n in shape)

    def __repr__(self):
        return f"AbstractMesh({self.axis_sizes}, {self.axis_names})"


def abstract_mesh(shape, axes):
    """Device-free mesh for spec construction and tests."""
    return AbstractMesh(shape, axes)


def placements(spec, mesh):
    """DTensor placements (one per mesh dim) of a spec on ``mesh``: an
    axis named at dim ``d`` of the spec is ``Shard(d)``, any other axis
    ``Replicate()``. A dim over several axes is split in mesh order,
    major to minor, so those axes must appear in the spec in mesh
    order."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    at = {}
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for a in axes:
            if a in at:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            at[a] = d
    return tuple(Shard(at[a]) if a in at else Replicate() for a in names)


class Policy:
    """``tuned=False`` is the reference's naive baseline; ``tuned=True``
    shards wq/wk/wv/wo on 'model' only when the head count divides the
    axis, and MoE expert stacks over ('data', 'model') when the expert
    count divides both."""

    def __init__(self, cfg, mesh, *, tuned: bool = False, strategy: str = "2d"):
        """strategy='2d': batch on ('pod','data'), tensor-parallel on
        'model' (+ ZeRO-3 on 'data' when cfg.fsdp_weights).
        strategy='fsdp': batch on ('pod','data','model') and every weight
        ZeRO-3-sharded across both intra-pod axes (no tensor
        parallelism); MoE experts keep the expert-parallel dimension."""
        if strategy not in ("2d", "fsdp"):
            raise ValueError(strategy)
        self.cfg = cfg
        self.mesh = mesh
        self.tuned = tuned
        self.strategy = strategy
        self.sizes = axis_sizes(mesh)
        if strategy == "fsdp":
            self.dp = tuple(a for a in ("pod", "data", "model")
                            if a in self.sizes)
        else:
            self.dp = tuple(a for a in ("pod", "data") if a in self.sizes)
        self.fsdp = "data" if (cfg is not None and getattr(cfg, "fsdp_weights", False)
                               and "data" in self.sizes) else None
        model = self.sizes.get("model", 1)
        self.heads_ok = cfg is None or cfg.n_heads % model == 0
        self.kv_ok = cfg is None or cfg.n_kv_heads % model == 0
        dm = model * self.sizes.get("data", 1)
        n_experts = getattr(cfg, "n_experts", 0) if cfg is not None else 0
        self.experts_2d = bool(n_experts and n_experts % dm == 0)

    def dp_size(self):
        n = 1
        for a in self.dp:
            n *= self.sizes[a]
        return n

    def _fit(self, spec, shape):
        """Replace axes that don't divide their dim with None. A one-axis
        tuple reads as the bare axis name, as a JAX ``PartitionSpec``
        reads it."""
        out = []
        for dim, ax in zip(shape, spec):
            if ax is None:
                out.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n = 1
            for a in axes:
                n *= self.sizes.get(a, 1)
            if isinstance(ax, tuple) and len(ax) == 1:
                ax = ax[0]
            out.append(ax if dim % n == 0 else None)
        return tuple(out)

    def _base_param_spec(self, names, shape):
        last = names[-1]
        parent = names[-2] if len(names) > 1 else ""
        F = self.fsdp
        nd = len(shape)
        if parent in NORM_PARENTS or last in RWKV_SMALL or last == "gate_attn":
            return (None,) * nd
        if last == "emb":
            # vocab-sharded (the reference's GSPMD gather path)
            return (None, "model", None)
        if parent == "lm_head":
            return (None, "model") if last == "w" else ("model",)
        if parent in ("cond_proj",):
            return (None,) * nd
        if parent == "mlp" and nd == 3 and last in ("gate", "up"):
            if self.tuned and self.experts_2d:
                return (("data", "model"), None, None)
            return ("model", None, F)          # MoE experts
        if parent == "mlp" and nd == 3 and last == "down":
            if self.tuned and self.experts_2d:
                return (("data", "model"), None, None)
            return ("model", F, None)
        if last == "router":
            return (None, None)
        if last == "conv_w":
            return (None, "model")
        if last in ("conv_b", "dt_bias", "D"):
            return ("model",)
        if last == "A_log":
            return ("model", None)
        if parent == "x_proj":
            return ("model", None) if last == "w" else (None,)
        if parent == "dt_w":
            return (None, "model") if last == "w" else ("model",)
        if parent in COL_PARENTS:
            if self.tuned and parent in ("wk", "wv") and not self.kv_ok:
                return (F, None) if last == "w" else (None,)
            if self.tuned and parent == "wq" and not self.heads_ok:
                return (F, None) if last == "w" else (None,)
            return (F, "model") if last == "w" else ("model",)
        if parent in ROW_PARENTS:
            if self.tuned and parent == "wo" and not self.heads_ok:
                return (None, F) if last == "w" else (None,)
            return ("model", F) if last == "w" else (None,)
        if parent in ("wq_a", "wkv_a"):
            return (F, None) if last == "w" else (None,)
        if parent == "proj":                   # MTP projection
            return (F, None) if last == "w" else (None,)
        if last in ("wr", "wk", "wv", "wg") and nd == 2:   # rwkv matrices
            return (None, "model")
        if last == "wo" and nd == 2:
            return ("model", None)
        return (None,) * nd

    def param_spec(self, path, leaf):
        """The spec of the leaf at key path ``path``."""
        names = _path_names(path)
        shape = tuple(leaf.shape)
        stacked = 1 if names and names[0] == "groups" else 0
        base = self._base_param_spec(names, shape[stacked:])
        if self.strategy == "fsdp":
            base = self._to_fsdp(names, base, shape[stacked:])
        spec = (None,) * stacked + tuple(base)
        return self._fit(spec, shape)

    def _to_fsdp(self, names, base, shape):
        """Rewrite a 2D spec for the pure-FSDP strategy: the former
        tensor-parallel ('model') placement is dropped and the largest
        dim is ZeRO-3-sharded over ('data','model'). MoE expert stacks
        keep the expert dim sharded (never gathered whole)."""
        last = names[-1]
        parent = names[-2] if len(names) > 1 else ""
        both = ("data", "model")
        if parent == "mlp" and len(shape) == 3 and last in ("gate", "up", "down"):
            if self.experts_2d:
                return (both, None, None)
            return ("model", "data" if shape[1] % self.sizes.get("data", 1) == 0
                    else None, None) if last != "down" else ("model", "data", None)
        if len(shape) < 2 or all(a is None for a in base):
            return tuple(None for _ in shape)
        # shard the largest dim over both axes
        big = max(range(len(shape)), key=lambda i: shape[i])
        return tuple(both if i == big else None for i in range(len(shape)))

    def param_pspecs(self, params):
        """``params`` with every leaf replaced by its spec (same nesting;
        a spec is a tuple leaf, so walk the result with the params'
        paths, not with ``training.tree``)."""
        return map_with_path(self.param_spec, params)

    # ------------------------------------------------------------ caches

    def cache_spec(self, path, leaf, *, long=False):
        names = _path_names(path)
        last = names[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        dp = self.dp
        bat = None if long else dp
        # every cache leaf is stacked: (count, B, ...) except 'pos' (count, W)
        if last == "pos":
            return (None,) * nd
        if last in ("k", "v") and nd == 5:          # (count,B,W,KV,D) self-attn
            return self._fit((None, bat, dp if long else None, "model", None),
                             shape)
        if last in ("ckv", "krope"):                # (count,B,W,r)
            return self._fit((None, bat, dp if long else None, None), shape)
        if "cross" in names or "cond" in names:     # (count,B,Cs,KV,D)
            return self._fit((None, bat, None, "model", None), shape)
        if "ssm" in names and nd == 4 and shape[-1] != shape[-2]:
            # conv state (count,B,dc-1,di) or h (count,B,di,st)
            if shape[-2] > shape[-1]:
                return self._fit((None, bat, "model", None), shape)
            return self._fit((None, bat, None, "model"), shape)
        if last == "state" and nd == 5:             # rwkv (count,B,H,hd,hd)
            return self._fit((None, bat, "model", None, None), shape)
        if nd >= 2:
            return self._fit((None, bat) + (None,) * (nd - 2), shape)
        return (None,) * nd

    def cache_pspecs(self, cache, *, long=False):
        return map_with_path(lambda p, l: self.cache_spec(p, l, long=long),
                             cache)

    # ------------------------------------------------------------- misc

    def batch_spec(self, leaf):
        return self._fit((self.dp,) + (None,) * (leaf.dim() - 1),
                         tuple(leaf.shape))

    def batch_pspecs(self, batch):
        return map_with_path(lambda _, leaf: self.batch_spec(leaf), batch)

    def opt_pspecs(self, params, opt_state):
        """Optimizer state mirrors param sharding (factored dims inherit):
        AdamW ``m``/``v`` take the param's spec, Adafactor's ``vr`` drops
        its last entry and ``vc`` its second-to-last, ``step`` is
        replicated."""
        pspecs = self.param_pspecs(params)

        def match(path, leaf):
            names = _path_names(path)
            nd = leaf.dim()
            if names and names[-1] == "step":
                return ()
            # walk to the corresponding param spec by stripping m/v/vr/vc keys
            stripped = [n for n in names if n not in ("m", "v", "vr", "vc")]
            sub = pspecs
            for n in stripped:
                if isinstance(sub, dict) and n in sub:
                    sub = sub[n]
                elif isinstance(sub, list):
                    sub = sub[int(n)]
                else:
                    return (None,) * nd
            if not _is_spec(sub):
                return (None,) * nd
            spec = tuple(sub)
            if names[-1] == "vr":       # param shape minus last dim
                spec = spec[:-1]
            elif names[-1] == "vc":     # param shape minus second-to-last
                spec = spec[:-2] + spec[-1:]
            spec = spec + (None,) * (nd - len(spec))
            return self._fit(spec[:nd], tuple(leaf.shape))

        return map_with_path(match, opt_state)

    def shardings(self, pspecs):
        """The specs of a tree as DTensor placements on this policy's
        mesh (``placements``), leaf for leaf."""
        return map_specs(lambda s: placements(s, self.mesh), pspecs)

    def constrain(self, x):
        """Activation constraint for (B, S, d) hiddens: a DTensor is
        redistributed to batch-sharded on ``dp`` (replicated on every
        other axis); anything else passes through unchanged."""
        from .spmd import is_dtensor
        if is_dtensor(x) and x.dim() == 3:
            want = placements(self._fit((self.dp, None, None),
                                        tuple(x.shape)), x.device_mesh)
            if tuple(x.placements) != want:
                x = x.redistribute(x.device_mesh, want)
        return x


def _is_spec(x):
    """A spec is a tuple of axis names, tuples of names and Nones."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str)
        or (isinstance(a, tuple) and all(isinstance(b, str) for b in a))
        for a in x)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of tensors (dicts, lists, tuples),
    keeping its nesting; ``path`` holds dict keys and list indices."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def map_specs(fn, specs):
    """``fn`` over the spec leaves of a spec tree (specs are tuples, so
    a tuple node is a spec only if it holds no tensors or subtrees)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list) or (isinstance(specs, tuple)
                                   and not _is_spec(specs)):
        return type(specs)(map_specs(fn, v) for v in specs)
    return fn(specs)


def abstract_params(cfg, init_fn):
    """Shape-only params on the ``meta`` device (no allocation, nothing
    drawn): ``init_fn(cfg, gen, device="meta")``."""
    import torch
    return init_fn(cfg, torch.Generator(), device="meta")
