"""Sharding policy, parameter half: map a parameter tree to partition specs.

The reference's policy (MaxText-style 2D "FSDP + tensor parallel"):
  * mesh axes: ('pod', 'data', 'model') multi-pod, ('data', 'model') single.
  * weights: the tensor-parallel dim (heads / d_ff / experts) shards on
    'model'; when ``cfg.fsdp_weights`` the other big dim shards on
    'data' (ZeRO-3). Weights are never sharded on 'pod'.
  * any dim not divisible by its mesh axis falls back to replication.

A spec is a plain tuple with one entry per dim: an axis name, a tuple of
axis names, or None (replicated along that dim). ``param_pspecs`` maps
the port's nested dicts and lists of tensors, walking them with the
reference's key paths (``training.tree.paths``: dict keys, list
indices), so each leaf gets the spec the reference gives the same leaf.

Only this half is ported; the cache, batch and optimizer specs and the
placement of activations belong to ROADMAP item 12.
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
    """{axis name: size} of a mesh with ``axis_names`` and a ``devices``
    array (``fleet.region.FleetMesh``)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


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

    def _fit(self, spec, shape):
        """Replace axes that don't divide their dim with None."""
        out = []
        for dim, ax in zip(shape, spec):
            if ax is None:
                out.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n = 1
            for a in axes:
                n *= self.sizes.get(a, 1)
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
        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(v, path + (i,))
                                  for i, v in enumerate(tree))
            return self.param_spec(path, tree)
        return walk(params, ())
