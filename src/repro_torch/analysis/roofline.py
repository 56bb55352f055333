"""Roofline analysis of a step's per-device counts, H100 constants.

The port of ``repro.analysis.roofline``. Three terms (seconds), per
device:
  compute    = FLOPs / peak_FLOPs         (989 TFLOP/s bf16 dense / GPU)
  memory     = HBM bytes / HBM_bw         (3.35 TB/s / GPU)
  collective = collective bytes / link_bw (50 GB/s / GPU, see LINK_BW)

The constants are NVIDIA's H100 SXM datasheet figures at the card's
700 W limit. ``LINK_BW`` is the one-direction rate of the ConnectX-7
NIC each GPU has for traffic between nodes, 400 Gb/s = 50 GB/s. NVLink
gives a GPU 900 GB/s (both directions, 450 GB/s each way), but only
inside one 8-GPU node, and every axis of the production meshes spans
nodes: the 16 ranks of 'model' cover two nodes and those of 'data' 16
(ranks in row-major order, 8 to a node), so a ring over either axis
crosses the node link, and the slowest link paces a ring.

The per-device FLOPs and collective bytes come from
``hlo_analyzer.analyze_step`` (the aten ops of one step on this rank's
blocks); the HBM term is the reference's first-principles model
(``analytic_hbm_bytes``), with the walker's materialised-result bytes
recorded beside it as an upper bound. The reference's
``collective_bytes(hlo_text)`` and ``_shape_bytes`` parse compiled HLO
text; the port has no HLO, so they have no counterpart here: the
walker counts the collectives as they are dispatched. All-reduce traffic
is counted twice (ring reduce-scatter + all-gather phases).
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12          # bf16 dense / GPU (H100 SXM)
HBM_BW = 3.35e12             # bytes/s / GPU (HBM3)
LINK_BW = 50e9               # bytes/s / GPU between nodes (ConnectX-7, 400 Gb/s)


def weighted_collective_bytes(by_kind: dict) -> float:
    """Ring-algorithm traffic weights: AR moves ~2x its buffer."""
    w = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}
    return sum(by_kind[k] * w[k] for k in by_kind)


@dataclass
class Roofline:
    flops: float                 # per device (aten matmul-family ops)
    hbm_bytes: float             # per device (analytic model)
    coll_bytes: float            # per device (weighted, dispatched collectives)
    model_flops: float = 0.0     # 6*N*D (useful compute, global)
    chips: int = 256
    hbm_bytes_hlo: float = 0.0   # op-granularity result bytes (recorded)

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self):
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def as_dict(self):
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "hbm_bytes_hlo_upper_bound": self.hbm_bytes_hlo,
        }


def model_flops(cfg, shape) -> float:
    """6*N*D (training) or 2*N*D (inference) with N = active params."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def analytic_hbm_bytes(cfg, shape, *, model_shards=16, data_shards=16,
                       pods=1, experts_2d=False) -> float:
    """First-principles per-device HBM traffic per step (the roofline
    memory term). The walker's byte count is recorded alongside as an
    upper bound: it counts every op's result, where fused kernels keep
    intermediates on chip.

    Model: each device streams its tensor-parallel weight slice
    (gathered over the FSDP axis, so the slice is W/model_shards) once
    per forward and once per backward pass per microbatch, plus gradient
    writes, plus activation traffic (remat: one write + two reads of
    layer I/O), plus decode-cache read/write."""
    dtype_b = 2.0                                  # bf16
    total = cfg.param_count()
    if experts_2d and cfg.n_experts:
        # routed experts sharded over data x model, rest over model
        routed = 0
        for specs, count in cfg.groups:
            for s in specs:
                if s.mlp == "moe":
                    routed += count * cfg.n_experts * 3 * cfg.d_model * cfg.moe_d_ff
        W = ((total - routed) / model_shards
             + routed / (model_shards * data_shards)) * dtype_b
    else:
        W = total * dtype_b / model_shards
    d = cfg.d_model
    L = cfg.n_layers
    dp = data_shards * pods

    if shape.kind == "train":
        M = max(cfg.train_microbatches, 1)
        tokens_local = shape.global_batch * shape.seq_len / dp
        act = tokens_local * d * dtype_b * L * 3.0     # write + 2 reads
        grads_opt = 3.0 * W * 2.0                      # f32 grads + opt I/O
        return M * 2.0 * W + grads_opt + act
    if shape.kind == "prefill":
        tokens_local = shape.global_batch * shape.seq_len / dp
        act = tokens_local * d * dtype_b * L * 2.0
        cache = _cache_bytes(cfg, shape, dp)
        return W + act + cache
    # decode: weights once + cache read/write
    return W + 2.0 * _cache_bytes(cfg, shape, dp)


def _cache_bytes(cfg, shape, dp) -> float:
    """Per-device decode-cache bytes for this arch family."""
    from ..serving.kv_cache import cache_plan
    cache_len, _ = cache_plan(cfg, shape)
    B = shape.global_batch
    dtype_b = 2.0
    total = 0.0
    for specs, count in cfg.groups:
        for s in specs:
            if s.mixer == "attn":
                total += count * B * cache_len * cfg.kv_dim * 2 * dtype_b
            elif s.mixer == "mla":
                m = cfg.mla
                total += count * B * cache_len * (m.kv_lora_rank
                                                  + m.qk_rope_dim) * dtype_b
            elif s.mixer == "mamba":
                di = cfg.mamba.d_inner(cfg.d_model)
                total += count * B * di * (cfg.mamba.d_state * 4
                                           + cfg.mamba.d_conv * dtype_b)
            elif s.mixer == "rwkv6":
                hd = cfg.rwkv_head_dim
                total += count * B * (cfg.d_model // hd) * hd * hd * 4
    return total / dp


def mesh_shards(chips: int):
    """(model_shards, data_shards, pods): one card, or the production
    meshes' (16, 16) per pod with 2 pods at 512 chips."""
    if chips == 1:
        return 1, 1, 1
    return 16, 16, 2 if chips == 512 else 1


def analyze(totals, cfg, shape, chips: int,
            experts_2d: bool = False) -> Roofline:
    """Roofline terms from a step's per-device ``hlo_analyzer.Totals``
    on ``chips`` devices (1: the step unplaced on one card)."""
    model_shards, data_shards, pods = mesh_shards(chips)
    return Roofline(
        flops=totals.flops,
        hbm_bytes=analytic_hbm_bytes(cfg, shape, model_shards=model_shards,
                                     data_shards=data_shards, pods=pods,
                                     experts_2d=experts_2d),
        coll_bytes=weighted_collective_bytes(totals.coll),
        model_flops=model_flops(cfg, shape),
        chips=chips,
        hbm_bytes_hlo=totals.bytes,
    )
