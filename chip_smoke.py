#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device  the card, its power limit, the software versions; TF32 off.
  build   every kernel under src/repro_torch/csrc built with nvcc.
  kernel  the CUDA flash-attention kernel against its plain PyTorch
          version on the card, at the serving shapes and at the other
          modes' shapes: max |diff| <= 1e-4, exact zeros on fully masked
          rows, one launch counted per call; times of the kernel, the
          plain version and F.scaled_dot_product_attention (a yardstick
          only: the port never calls it), and the least time the card
          could take for the same work.
  serve   EMSNet TinyBERT-GRU-FC served per event by EMSServe on Table-6
          episodes 1-3 (adaptive offload under mobility, an edge crash in
          episode 2): the kernel must be launched exactly layers x
          text-consuming models x text events times, every recommendation
          finite, and the same episodes on the CPU (plain versions, the
          same profile table) must pick the same model, tier and cache
          hits, with outputs within 1e-4.
  int8    the CUDA quantize, dequantize and int8 GEMM kernels against
          their plain PyTorch versions on the card at every shape the
          tiered int8 path gives them (plus (33,100)x(100,130), an
          all-zero row and .5 ties): bit-equal, one launch counted per
          call; times of kernel, plain version and, where one PyTorch call
          computes the same function, that call (torch._int_mm for the
          GEMM's integer product, q * scale for dequantize), and the bound.
  tiered  the tiered EMSServeEngine at full width on the card: 4 sessions
          of the mix scenario over the 7-model zoo, tiers glass/ph1/
          edge64x, precision ph1=int8,edge64x=int8, the edge link at 28 m
          NLOS, edge64x crashed inside one of its flights. Checks int8
          and fp32 flights and a failover; int8_matmul launches ==
          4 x layers x int8 text flights + int8 vitals + int8 scene
          flights; flash launches == layers x text encodes; launches of the
          three int8 kernels == the calls of a CPU run of the same
          episodes with the same profile table, whose timeline must match
          (t_emit within 1e-9) with outputs within 1e-4, or INT8_TOL where
          the fusion read an int8 feature; the packed int8 features of
          each modality within INT8_LEVELS levels of the CPU's; INT8_TOL
          below the int8 path's own distance from the float32 path (the
          same episodes with no precision map) by at least TOL_ROOM; the
          all-fp32 precision map bit-identical to no map on the card.
          Reports the largest |output|, per-arrival wall p50/p99, the
          card's busy share, enc:text wall fp32 vs int8 and the feature
          wire's shrink.
  cli     the launcher's default command and its tiered int8 command on
          the card.

The last lines are the card's name and power limit as nvidia-smi prints
them, the kernels' summary, and {"ok": true, "device": {...}}. Any failed
check raises, so the exit code is non-zero and no result line prints.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM published peaks at its 700 W limit (NVIDIA data sheet, dense):
# HBM3 bandwidth and float32 outside the tensor cores, the unit the flash
# kernel computes on
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12      # int8 tensor cores, dense
TOL = 1e-4          # kernel vs plain version, float32 on the card
# outputs that fused an int8 feature, card vs CPU: float32 sums in
# another order move an activation by ~1e-6, enough to flip its int8
# rounding by one level now and then. One level is max|x|/127 of that
# row; the int8 sidecar's own error against float32, a sum of such
# half-level errors, reaches 8 % of an output's scale (the reference's
# bound in tests/test_quantized.py), and a handful of flips is a small
# part of it. INT8_TOL sits between the two, with at least TOL_ROOM on
# each side: the card-vs-CPU reading below it and the int8-vs-float32
# distance above it, so the check would fail an int8 flight that ran the
# float32 path. Both readings (0.0120 and 0.0458 on the H100): PERF.md.
INT8_TOL = 2.3e-2
TOL_ROOM = 1.9
# packed int8 features, card vs CPU: a flipped rounding inside the
# encoder moves a feature element by a level (measured: 1, in 23 of the
# text feature's 312 elements), never by more than a few
INT8_LEVELS = 2
SLEEP_CYCLES = 20_000_000   # ~10 ms: the host queues a timed run ahead of the card


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- device

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script measures the port on a CUDA card")
    # float32 products stay float32: the tolerances assume it (TF32 keeps
    # ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    smi = smi.strip().splitlines()[0]
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi


# ----------------------------------------------------------------- build

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    seconds = time.perf_counter() - t0
    emit("build", seconds=seconds, kernels={
        name: {"cached": r["cached"],
               "ptxas": [ln.strip() for ln in r["ptxas"].splitlines()
                         if "registers" in ln or "spill" in ln]}
        for name, r in report.items()})


# ---------------------------------------------------------------- kernel

def device_ms(fn, *, reps=25, per_rep=10):
    """Median over ``reps`` of the card's time per call, CUDA events
    around ``per_rep`` back-to-back calls queued behind a sleep kernel,
    so the host's launch overhead stays out of the reading."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(per_rep):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per_rep)
    return statistics.median(times)


def call_ms(fn, *, reps=50):
    """Host wall time per synchronised call: what one serving call waits."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(q, v, mask, H, KV, extra_bytes):
    """Least time the card could take: bytes each input read once and the
    output written once (K/V rows only where some query sees them) over
    HBM bandwidth, against the (q, k) pairs this data unmasks times
    2 (D + Dv) FLOPs over the float32 rate."""
    B, Sq, _, D = q.shape
    Dv = v.shape[-1]
    pairs = int(mask.sum()) * H
    key_rows = int(mask.any(dim=1).sum())
    nbytes = 4 * (B * Sq * H * (D + Dv) + key_rows * KV * (D + Dv)) + extra_bytes
    flops = 2 * (D + Dv) * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes)


def kernel_case(name, *, B, Sq, Sk, H, KV, D, causal=False, window=0,
                lengths=None, segments=None, block=128, fused_qkv=False,
                seed=0):
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    if fused_qkv:        # the text encoder's layout: views of one qkv buffer
        qkv = torch.randn((B, Sq, 3, H, D), generator=g).to(dev)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn((B, Sq, H, D), generator=g).to(dev)
        k = torch.randn((B, Sk, KV, D), generator=g).to(dev)
        v = torch.randn((B, Sk, KV, D), generator=g).to(dev)
    kw = dict(causal=causal, window=window)
    extra = 0
    if lengths is not None:
        kw["kv_lengths"] = torch.tensor(lengths, dtype=torch.int32, device=dev)
        extra = 4 * B
    if segments is not None:
        kw["segment_ids"] = torch.tensor(segments, dtype=torch.int32,
                                         device=dev)
        extra = 4 * B * Sq
    mask = FA.attention_mask(B, Sq, Sk, device=dev, **kw)

    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, block_q=block, block_k=block, **kw)
    torch.cuda.synchronize()
    check(FA.flash_attention.launches == before + 1,
          f"{name}: launches {FA.flash_attention.launches} != {before + 1}")
    want = FA.flash_attention_plain(q, k, v, **kw)
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(err <= TOL, f"{name}: max |kernel - plain| = {err} > {TOL}")
    dead = ~mask.any(dim=2)                     # (B, Sq) rows seeing no key
    n_dead = int(dead.sum())
    if n_dead:
        check(float(got[dead].abs().max()) == 0.0,
              f"{name}: fully masked rows are not exactly 0")

    kfn = lambda: FA.flash_attention(q, k, v, block_q=block, block_k=block, **kw)  # noqa: E731
    pfn = lambda: FA.flash_attention_plain(q, k, v, **kw)  # noqa: E731
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_kw = {"attn_mask": mask[:, None]}
    if KV != H:
        sdpa_kw["enable_gqa"] = True
    lfn = lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)  # noqa: E731
    ms, plain_ms = device_ms(kfn), device_ms(pfn)
    # SDPA takes grouped kv heads from torch 2.5 on; else no yardstick
    gqa_ok = KV == H or tuple(map(int, torch.__version__.split(".")[:2])) >= (2, 5)
    library_ms = device_ms(lfn) if gqa_ok else None
    b_ms, b_by, flops, nbytes = bound(q, v, mask, H, KV, extra)
    row = dict(name=name, shape=dict(B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, D=D),
               max_abs_err=err, zero_rows=n_dead, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, call_ms=call_ms(kfn),
               plain_call_ms=call_ms(pfn), bound_ms=b_ms, bound_by=b_by,
               flops=flops, bytes=nbytes)
    emit("kernel", **row)
    return row


def phase_kernel():
    rng = np.random.default_rng(0)
    rows = {}
    # TinyBERT per event: d=312, 12 heads of 26, one 64-token utterance
    rows["per_event"] = kernel_case(
        "tinybert_per_event", B=1, Sq=64, Sk=64, H=12, KV=12, D=26,
        lengths=[64], fused_qkv=True)
    lens = rng.integers(0, 65, 64)
    lens[0], lens[1] = 0, 64
    rows["padded"] = kernel_case(
        "tinybert_padded_batch", B=64, Sq=64, Sk=64, H=12, KV=12, D=26,
        lengths=lens.tolist(), fused_qkv=True, seed=1)
    seg = np.full(512, -1, np.int32)            # packed rows with -1 gaps
    o = 0
    for i, n in enumerate([40, 7, 64, 1, 100, 33, 64, 90]):
        seg[o:o + n] = i
        seg[o + n // 2] = -1                    # an interior PAD token
        o += -(-n // 8) * 8 + 8
    rows["segments"] = kernel_case(
        "tinybert_segments", B=1, Sq=512, Sk=512, H=12, KV=12, D=26,
        segments=[seg.tolist()], block=8, fused_qkv=True, seed=2)
    rows["causal_gqa"] = kernel_case(
        "causal_window16_gqa", B=1, Sq=256, Sk=256, H=8, KV=2, D=64,
        causal=True, window=16, seed=3)
    rows["bertbase"] = kernel_case(
        "bertbase", B=8, Sq=128, Sk=128, H=12, KV=12, D=64,
        lengths=[128] * 8, fused_qkv=True, seed=4)
    return rows


# ----------------------------------------------------------------- serve

def run_episodes(splits, params, payloads, table, device, *, cached=True,
                 crash=(2, 12)):
    from repro_torch.core import (AdaptiveOffloadPolicy, EMSServe,
                                  HeartbeatMonitor, table6)
    from repro_torch.launch.serve import _mobility_trace
    out = []
    for ep in (1, 2, 3):
        policy = AdaptiveOffloadPolicy(table, HeartbeatMonitor(
            _mobility_trace(True)))
        eng = EMSServe(splits, params, policy=policy, cached=cached,
                       device=device)
        walls = []
        t0 = time.perf_counter()
        for i, ev in enumerate(table6()[ep]):
            if (ep, i) == crash:
                eng.crash_edge()
            t1 = time.perf_counter()
            eng.on_event(ev, payloads[ev.modality])
            walls.append(time.perf_counter() - t1)
        out.append({"episode": ep, "engine": eng,
                    "wall_s": time.perf_counter() - t0, "event_s": walls})
    return out


def device_time(fn, kernel_name):
    """(the card's busy microseconds, the kernel's share of them, the
    profiled wall microseconds) over one call of ``fn``, from
    torch.profiler; (None, None, wall) where the trace holds no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    total = kern = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        total += t
        if kernel_name in e.key:
            kern += t
    if total <= 0:
        return None, None, wall_us
    return total, kern / total, wall_us


def phase_serve():
    from repro_torch.configs.emsnet import config
    from repro_torch.core import ProfileTable, profile
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import build_models, sample_payloads

    cfg = config(text_encoder="tinybert", vocab_size=2048)
    check(cfg.use_flash_text, "the port's serving config must use the kernel")
    splits, params = build_models(cfg, seed=0, device="cuda")
    payloads = sample_payloads(cfg)
    table = ProfileTable(base=profile(splits["m3"], params["m3"], payloads,
                                      device="cuda"))

    FA.flash_attention.launches = 0             # the main path starts here
    gpu = run_episodes(splits, params, payloads, table, "cuda")
    launches = FA.flash_attention.launches      # ... and ends here

    n_layers = cfg.text_dims[0]
    text_models = sum("text" in sm.modalities() for sm in splits.values())
    text_events = sum(r.modality == "text" for run in gpu
                      for r in run["engine"].records)
    expected = n_layers * text_models * text_events
    check(text_events == 3, f"expected one text event per episode, got "
          f"{text_events}")
    check(launches == expected, f"flash kernel launched {launches} times, "
          f"expected {n_layers} layers x {text_models} models x "
          f"{text_events} text events = {expected}")
    n_recs = 0
    for run in gpu:
        for r in run["engine"].records:
            if r.recommendation is None:
                continue
            n_recs += 1
            for k, t in r.recommendation.items():
                check(bool(torch.isfinite(t).all()), f"non-finite {k}")
            check(tuple(r.recommendation["protocol_logits"].shape)
                  == (1, cfg.n_protocols), "protocol logits shape")
    check(n_recs > 0, "no recommendation was served")

    # the same episodes on the CPU: plain versions, same weights (drawn on
    # the CPU from the same seed), the ONE profile table
    cpu_splits, cpu_params = build_models(cfg, seed=0, device="cpu")
    cpu = run_episodes(cpu_splits, cpu_params, payloads, table, "cpu")
    max_diff = 0.0
    for g_run, c_run in zip(gpu, cpu):
        g_recs, c_recs = g_run["engine"].records, c_run["engine"].records
        check(len(g_recs) == len(c_recs), "record counts differ")
        for a, b in zip(g_recs, c_recs):
            check((a.model, a.tier, a.cache_hits)
                  == (b.model, b.tier, b.cache_hits),
                  f"episode {g_run['episode']} event {a.index}: cuda "
                  f"{(a.model, a.tier, a.cache_hits)} != cpu "
                  f"{(b.model, b.tier, b.cache_hits)}")
            check((a.recommendation is None) == (b.recommendation is None),
                  "recommendation presence differs")
            if a.recommendation is not None:
                for k in a.recommendation:
                    d = float((a.recommendation[k].cpu()
                               - b.recommendation[k]).abs().max())
                    max_diff = max(max_diff, d)
    check(max_diff <= TOL, f"cuda vs cpu outputs differ by {max_diff} > {TOL}")

    # the same three episodes once more under the profiler; the busy share
    # is taken against the unprofiled run's wall time (the profiler slows
    # the host) and against the profiled run's own
    busy_us, share, prof_wall_us = device_time(
        lambda: run_episodes(splits, params, payloads, table, "cuda"),
        "flash_fwd_kernel")
    gpu_wall_us = 1e6 * sum(run["wall_s"] for run in gpu)
    direct = run_episodes(splits, params, payloads, table, "cuda",
                          cached=False)
    ev_ms = sorted(1e3 * s for run in gpu for s in run["event_s"])
    sim = {c: sum(run["engine"].cumulative_time() for run in runs)
           for c, runs in (("cached", gpu), ("direct", direct))}
    wall = {c: sum(run["wall_s"] for run in runs)
            for c, runs in (("cached", gpu), ("direct", direct))}
    emit("serve", config="tinybert-gru-fc vocab 2048", launches=launches,
         expected_launches=expected, text_events=text_events,
         recommendations=n_recs, cpu_max_abs_diff=max_diff,
         profile_s=table.base,
         episode_wall_s={run["episode"]: run["wall_s"] for run in gpu},
         event_ms_p50=float(np.percentile(ev_ms, 50)),
         event_ms_p99=float(np.percentile(ev_ms, 99)),
         flash_share_of_gpu_time=share, gpu_busy_us=busy_us,
         gpu_busy_share_of_wall=(busy_us / gpu_wall_us if busy_us else None),
         gpu_busy_share_of_profiled_wall=(busy_us / prof_wall_us
                                          if busy_us else None),
         direct_over_cached_sim=sim["direct"] / sim["cached"],
         direct_over_cached_wall=wall["direct"] / wall["cached"],
         sim_s=sim, wall_s=wall)
    return launches


# ------------------------------------------------------------------ int8

def int8_bound(kind, M, K, N=0):
    """Least time the card could take: each input read once and each
    output written once over HBM bandwidth, against the operations these
    inputs need over the peak rate of their unit — 2 M K N int8 operations
    on the tensor cores for the GEMM; for quantize 4 float32 operations an
    element (abs-max, divide, round, clamp) and for dequantize one
    multiply, on the float32 units."""
    if kind == "gemm":
        nbytes = M * K + K * N + 4 * M + 4 * N + 4 * M * N
        ops, rate = 2 * M * K * N, INT8_OP_PER_S
    elif kind == "quantize":
        nbytes = 4 * M * K + M * K + 4 * M
        ops, rate = 4 * M * K, FP32_FLOP_PER_S
    else:
        nbytes = M * K + 4 * M + 4 * M * K
        ops, rate = M * K, FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops, nbytes)


def int8_case(name, kernel, fn, plain, *, bound_args, library=None):
    """One kernel call on the card against its plain version: bit-equal
    (max_abs_err is 0 then), exactly one launch counted; then times."""
    before = kernel.launches
    got = fn()
    torch.cuda.synchronize()
    check(kernel.launches == before + 1,
          f"{name}: launches {kernel.launches} != {before + 1}")
    want = plain()
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for a, b in zip(got_t, want_t):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{name}: {a.dtype}{tuple(a.shape)} != {b.dtype}{tuple(b.shape)}")
        err = max(err, float((a.double() - b.double()).abs().max())
                  if a.numel() else 0.0)
        check(torch.equal(a, b), f"{name}: kernel != plain version "
              f"(max |diff| {err})")
    b_ms, b_by, ops, nbytes = int8_bound(*bound_args)
    row = dict(name=name, kernel=kernel.__name__, shape=bound_args[1:],
               max_abs_err=err, ms=device_ms(fn), plain_ms=device_ms(plain),
               library_ms=device_ms(library) if library is not None else None,
               call_ms=call_ms(fn), bound_ms=b_ms, bound_by=b_by, ops=ops,
               bytes=nbytes)
    emit("int8", **row)
    return row


def phase_int8():
    from repro_torch.kernels import quantized as Q
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return (torch.randn(shape, generator=g) * 2.0).to(dev)

    rows = {}

    def quant(name, x):
        M, K = x.shape
        rows[name] = int8_case(name, Q.quantize_rowwise,
                               lambda: Q.quantize_rowwise(x),
                               lambda: Q.quantize_rowwise_plain(x),
                               bound_args=("quantize", M, K))

    # activations of one int8 text layer, vitals, scene; packed features
    for M, K in ((64, 312), (64, 1200), (30, 6), (1, 3), (1, 312), (1, 64),
                 (1, 16), (33, 100)):
        quant(f"quantize_{M}x{K}", randn(M, K))
    # weights, once per sidecar: the rowwise kernel over the view w.T
    for K, N in ((312, 936), (312, 312), (312, 1200), (1200, 312), (6, 192),
                 (3, 16)):
        quant(f"quantize_colwise_{K}x{N}", randn(K, N).T)
    ties = torch.zeros((3, 8))
    ties[1] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5])
    quant("quantize_zero_rows_and_ties", ties.to(dev))
    q, s = Q.quantize_rowwise(ties.to(dev))
    check(q[1].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]
          and s[:, 0].tolist() == [1.0, 1.0, 1.0]
          and int(q[0].abs().max()) == 0 and int(q[2].abs().max()) == 0,
          f"ties/zero rows: q={q.tolist()} scale={s.tolist()}")

    for M, K in ((1, 312), (1, 64), (1, 16), (33, 100)):
        qq, ss = Q.quantize_rowwise_plain(randn(M, K))
        rows[f"dequantize_{M}x{K}"] = int8_case(
            f"dequantize_{M}x{K}", Q.dequantize_rowwise,
            lambda: Q.dequantize_rowwise(qq, ss),
            lambda: Q.dequantize_rowwise_plain(qq, ss),
            library=lambda: torch.mul(qq, ss),
            bound_args=("dequantize", M, K))

    for M, K, N in ((64, 312, 936), (64, 312, 312), (64, 312, 1200),
                    (64, 1200, 312), (30, 6, 192), (1, 3, 16),
                    (33, 100, 130)):
        xq, sx = Q.quantize_rowwise_plain(randn(M, K))
        wq, sw = Q.quantize_rowwise_plain(randn(N, K))
        wq, sw = wq.T.contiguous(), sw.reshape(1, N)
        # torch._int_mm (the integer product alone) takes M > 16 and K, N
        # multiples of 8: the GEMM's yardstick where those rules allow
        lib = ((lambda: torch._int_mm(xq, wq))
               if M > 16 and K % 8 == 0 and N % 8 == 0 else None)
        rows[f"gemm_{M}x{K}x{N}"] = int8_case(
            f"int8_matmul_{M}x{K}x{N}", Q.int8_matmul,
            lambda: Q.int8_matmul(xq, sx, wq, sw),
            lambda: Q.int8_matmul_plain(xq, sx, wq, sw), library=lib,
            bound_args=("gemm", M, K, N))
    return rows


# ---------------------------------------------------------------- tiered

TIERED_PRECISION = {"ph1": "int8", "edge64x": "int8"}


def tiered_engine(splits, params, table, device, precision):
    """The slice's path as the launcher builds it: three tiers, the phone
    on a near-field tether, the glass<->edge link at 28 m NLOS (the
    low-uplink regime where quantized transport pays)."""
    from repro_torch.core import BandwidthTrace, nlos_bandwidth
    from repro_torch.serving.api import build_engine
    return build_engine(
        splits, params, "tiered", share_encoders=True, max_history=None,
        device=device, profile=table, tiers=("glass", "ph1", "edge64x"),
        trace=BandwidthTrace.static(nlos_bandwidth(28.0)),
        tier_traces={"ph1": BandwidthTrace.static(nlos_bandwidth(0.0))},
        precision=precision)


def serve_arrivals(eng, eps, payloads, *, crash_at=None):
    """Submit every arrival in global time order; wall seconds of each,
    the card synchronised after it."""
    from repro_torch.core import merge_arrivals
    if crash_at is not None:
        eng.inject_crash(crash_at)
    walls = []
    for _t, sid, ev in merge_arrivals(eps):
        t0 = time.perf_counter()
        eng.submit(sid, ev, payloads[ev.modality])
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _rec_key(r):
    return (r.sid, r.index, r.model, r.tier, r.enc_tier, r.tail_tier,
            r.precision, r.kind, r.fallback)


def fused_precision(eng):
    """For each record, "int8" where its fusion read an int8 feature (the
    fresh one, or a packed one in the session's cache), else "fp32".
    Every record commits its modality's feature at its precision, and a
    fusion reads the newest feature of each modality it consumes."""
    latest, out = {}, []
    for r in eng.records:
        latest[(r.sid, r.modality)] = r.precision
        mods = eng.models[r.model].modalities() if r.model else ()
        out.append("int8" if any(latest.get((r.sid, m)) == "int8"
                                 for m in mods) else "fp32")
    return out


def compare_runs(a_eng, b_eng, what, *, exact=False):
    """Same placement fields and timeline; outputs within 1e-4, or within
    INT8_TOL where the fusion read an int8 feature, or bit-equal with
    ``exact``. Returns the max |diff| of each class."""
    a_recs, b_recs = a_eng.records, b_eng.records
    check(len(a_recs) == len(b_recs), f"{what}: record counts differ")
    diff = {"fp32": 0.0, "int8": 0.0}
    for a, b, cls in zip(a_recs, b_recs, fused_precision(a_eng)):
        check(_rec_key(a) == _rec_key(b),
              f"{what}: {_rec_key(a)} != {_rec_key(b)}")
        check(abs(a.t_emit - b.t_emit) <= 1e-9
              and abs(a.t_start - b.t_start) <= 1e-9,
              f"{what}: timeline differs at {_rec_key(a)}")
        check((a.outputs is None) == (b.outputs is None),
              f"{what}: output presence differs")
        if a.outputs is None:
            continue
        for k in a.outputs:
            x, y = a.outputs[k], b.outputs[k].to(a.outputs[k].device)
            if exact:
                check(torch.equal(x, y), f"{what}: {k} not bit-identical")
            diff[cls] = max(diff[cls], float((x - y).abs().max()))
    emit("compare", what=what, max_abs_diff=diff)
    check(diff["fp32"] <= TOL, f"{what}: fp32 outputs differ by "
          f"{diff['fp32']} > {TOL}")
    check(diff["int8"] <= INT8_TOL, f"{what}: int8 outputs differ by "
          f"{diff['int8']} > {INT8_TOL}")
    check(a_eng.fabric.stats().keys() == b_eng.fabric.stats().keys()
          and all(a_eng.fabric.stats()[k]["bytes"]
                  == b_eng.fabric.stats()[k]["bytes"]
                  for k in a_eng.fabric.stats()),
          f"{what}: link bytes differ")
    return diff


def int8_counters():
    from repro_torch.kernels import quantized as Q
    return (Q.quantize_rowwise, Q.dequantize_rowwise, Q.int8_matmul)


def reset_counts():
    from repro_torch.kernels import flash_attention as FA
    FA.flash_attention.launches = 0
    for k in int8_counters():
        k.launches = k.calls = 0


def phase_tiered():
    from repro_torch.configs.emsnet import config
    from repro_torch.core import ProfileTable, profile
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantized as Q
    from repro_torch.launch.serve import (build_zoo, sample_payloads,
                                          scenario_episodes)
    from repro_torch.models.quantized import quantize_feature
    from repro_torch.serving.transport import payload_nbytes

    cfg = config(text_encoder="tinybert", vocab_size=2048)
    full = "text+vitals+scene"
    splits, params = build_zoo(cfg, seed=0, device="cuda")
    cpu_splits, cpu_params = build_zoo(cfg, seed=0, device="cpu")
    payloads = sample_payloads(cfg)
    # the card stands for the fastest edge box (TIER_FACTORS 1.0): glass
    # and phone times are the card's scaled by 107x and 23x
    table = ProfileTable(base=profile(splits[full], params[full], payloads,
                                      device="cuda"), host_tier="edge64x")
    eps = scenario_episodes(4, "mix")

    # the crash instant: inside an edge64x flight in the middle of the
    # run, found from the timeline of a CPU run (the timeline depends
    # only on the profile table, the traces and byte counts)
    probe = tiered_engine(cpu_splits, cpu_params, table, "cpu",
                          TIERED_PRECISION)
    serve_arrivals(probe, eps, payloads)
    flights = [r for r in probe.records if "edge64x" in (r.enc_tier,
                                                         r.tail_tier)
               and r.t_emit > r.t_start]
    check(flights, "no edge64x flight to crash inside")
    mid = probe.makespan_s() / 2
    flight = min(flights, key=lambda r: abs(r.t_start - mid))
    crash_at = (flight.t_start + flight.t_emit) / 2

    reset_counts()                              # the main path starts here
    eng = tiered_engine(splits, params, table, "cuda", TIERED_PRECISION)
    walls = serve_arrivals(eng, eps, payloads, crash_at=crash_at)
    launches = {k.__name__: k.launches for k in int8_counters()}
    calls = {k.__name__: k.calls for k in int8_counters()}
    launches["flash_attention"] = FA.flash_attention.launches
    wall_s = sum(walls)                         # ... and ends here

    recs = eng.records
    n_layers = cfg.text_dims[0]
    n8 = {m: sum(r.precision == "int8" and r.modality == m for r in recs)
          for m in ("text", "vitals", "scene")}
    n_text = sum(r.modality == "text" for r in recs)
    check(n8["text"] >= 1, "no int8 text flight")
    check(any(r.precision == "fp32" for r in recs), "no fp32 flight")
    check(eng.fallback_count >= 1 and any(r.fallback for r in recs),
          f"no failover (edge64x crashed at {crash_at})")
    want_gemm = 4 * n_layers * n8["text"] + n8["vitals"] + n8["scene"]
    check(launches["int8_matmul"] == want_gemm,
          f"int8_matmul launched {launches['int8_matmul']} times, expected "
          f"4 x {n_layers} x {n8['text']} + {n8['vitals']} + {n8['scene']}"
          f" = {want_gemm}")
    check(launches["flash_attention"] == n_layers * n_text,
          f"flash launched {launches['flash_attention']} times, expected "
          f"{n_layers} x {n_text}")
    check(calls == {k: launches[k] for k in calls},
          f"calls {calls} != launches {launches} on the card")
    check(len(eng._qparams_cache) == 1, "sidecar derived more than once")
    for r in recs:
        if r.outputs is not None:
            for k, t in r.outputs.items():
                check(bool(torch.isfinite(t).all()), f"non-finite {k}")

    # the same episodes on the CPU (plain versions, the same weights drawn
    # on the CPU from the same seed, the ONE profile table)
    reset_counts()
    cpu = tiered_engine(cpu_splits, cpu_params, table, "cpu",
                        TIERED_PRECISION)
    serve_arrivals(cpu, eps, payloads, crash_at=crash_at)
    cpu_calls = {k.__name__: k.calls for k in int8_counters()}
    check(all(k.launches == 0 for k in int8_counters()),
          "a CPU run launched a kernel")
    check(cpu_calls == calls, f"card launches {calls} != CPU calls "
          f"{cpu_calls}")
    diff = compare_runs(cpu, eng, "cpu vs cuda")

    # precision off vs an all-fp32 map, on the card: bit-identical
    off = tiered_engine(splits, params, table, "cuda", None)
    off_walls = serve_arrivals(off, eps, payloads, crash_at=crash_at)

    # the tolerance's control: how far the int8 path's outputs sit from
    # the float32 path's on the same arrivals, where the fusion read an
    # int8 feature; and the outputs' own size
    gap, max_out = 0.0, 0.0
    for a, b, cls in zip(recs, off.records, fused_precision(eng)):
        if a.outputs is None:
            continue
        max_out = max(max_out, max(float(t.abs().max())
                                   for t in a.outputs.values()))
        if cls == "int8" and b.outputs is not None and a.model == b.model:
            gap = max(gap, max(float((a.outputs[k] - b.outputs[k]).abs()
                                     .max()) for k in a.outputs))
    # the packed features of each modality, card vs CPU, in int8 levels
    levels = {}
    with torch.inference_mode():
        for m in ("text", "vitals", "scene"):
            got, want = (quantize_feature(e.models[full].encoders[m](
                             e._quantized_params(full), torch.as_tensor(
                                 payloads[m], device=e.device)))
                         for e in (eng, cpu))
            dq = (got["q"].cpu().int() - want["q"].int()).abs()
            levels[m] = {"elements": dq.numel(),
                         "differ": int((dq > 0).sum()),
                         "max_levels": int(dq.max()),
                         "scale_rel_diff": float(
                             ((got["scale"].cpu() - want["scale"]).abs()
                              / want["scale"]).max())}
    emit("int8_tolerance", card_vs_cpu=diff["int8"], int8_vs_fp32=gap,
         max_abs_output=max_out, int8_tol=INT8_TOL, room=TOL_ROOM,
         packed_levels=levels)
    check(diff["int8"] * TOL_ROOM <= INT8_TOL <= gap / TOL_ROOM,
          f"INT8_TOL {INT8_TOL} is not within x{TOL_ROOM} of both the "
          f"card-vs-CPU reading {diff['int8']} and the int8-vs-fp32 "
          f"control {gap}")
    for m, lv in levels.items():
        check(lv["max_levels"] <= INT8_LEVELS,
              f"packed {m} feature: card and CPU differ by "
              f"{lv['max_levels']} levels > {INT8_LEVELS}")
    mapped = tiered_engine(splits, params, table, "cuda",
                           {"ph1": "fp32", "edge64x": "fp32"})
    serve_arrivals(mapped, eps, payloads, crash_at=crash_at)
    compare_runs(off, mapped, "all-fp32 map vs no map", exact=True)

    # reported, not asserted: busy share of the card over one more int8
    # run, enc:text wall fp32 vs int8, the feature wire's shrink
    busy_us, _share, prof_wall_us = device_time(
        lambda: serve_arrivals(tiered_engine(splits, params, table, "cuda",
                                             TIERED_PRECISION),
                               eps, payloads, crash_at=crash_at),
        "int8_matmul_kernel")
    sm = splits[full]
    x = torch.as_tensor(payloads["text"], device="cuda")
    qparams = eng._quantized_params(full)
    with torch.inference_mode():
        text_fp32_ms = call_ms(lambda: sm.encoders["text"](params[full], x))
        text_int8_ms = call_ms(lambda: quantize_feature(
            sm.encoders["text"](qparams, x)))
        raw = {m: payload_nbytes(sm.encoders[m](
                   params[full], torch.as_tensor(payloads[m], device="cuda")))
               for m in ("text", "vitals", "scene")}
    packed = {m: cfg.feature_dims[m] + 4 for m in raw}
    off8 = [r for r in recs if r.precision == "int8"
            and r.enc_tier != "glass"]
    raw_b = sum(raw[r.modality] for r in off8)
    packed_b = sum(packed[r.modality] for r in off8)
    ms = sorted(1e3 * w for w in walls)
    emit("tiered", config="tinybert-gru-fc vocab 2048, 7-model zoo",
         sessions=4, arrivals=len(recs), crash_at=crash_at,
         launches=launches, calls=calls, cpu_calls=cpu_calls,
         int8_flights=n8, text_encodes=n_text,
         placement=eng.placement_counts(),
         precision_counts={p: sum(r.precision == p for r in recs)
                           for p in ("fp32", "int8")},
         fallbacks=eng.fallback_count, cpu_max_abs_diff=diff,
         int8_vs_fp32_max_abs_diff=gap, max_abs_output=max_out,
         profile_s=table.base,
         arrival_ms_p50=float(np.percentile(ms, 50)),
         arrival_ms_p99=float(np.percentile(ms, 99)),
         wall_s=wall_s, fp32_run_wall_s=sum(off_walls),
         sim_total_latency_s={"int8": eng.total_latency_s(),
                              "fp32": off.total_latency_s()},
         gpu_busy_us=busy_us,
         gpu_busy_share_of_wall=(busy_us / (1e6 * wall_s)
                                 if busy_us else None),
         gpu_busy_share_of_profiled_wall=(busy_us / prof_wall_us
                                          if busy_us else None),
         enc_text_call_ms={"fp32": text_fp32_ms, "int8": text_int8_ms},
         feature_bytes={"raw": raw, "packed": packed},
         offloaded_int8_feature_bytes={"fp32": raw_b, "int8": packed_b},
         wire_shrink_x=(raw_b / packed_b if packed_b else None),
         links=eng.fabric.stats())
    return launches


def phase_cli():
    from repro_torch.launch.serve import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--episode", "2", "--mobility", "--crash-edge-at", "12"])
    lines = buf.getvalue().strip().splitlines()
    check(lines[-1].startswith("cumulative serving time") and
          lines[-1].endswith("on cuda"), f"unexpected cli output {lines[-1:]}")
    check(sum("protocol=" in ln for ln in lines) > 0, "cli served nothing")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--engine", "tiered", "--tiers", "glass,ph1,edge64x",
              "--precision", "ph1=int8,edge64x=int8", "--sessions", "4",
              "--scenario", "mix", "--outage-at", "4"])
    tiered = buf.getvalue().strip().splitlines()
    check(tiered[-1].startswith("cumulative serving latency") and
          tiered[-1].endswith("on cuda"),
          f"unexpected tiered cli output {tiered[-1:]}")
    check(any("[int8]" in ln for ln in tiered), "tiered cli ran no int8 "
          "flight")
    emit("cli", lines=len(lines), last=lines[-1], tiered_lines=len(tiered),
         tiered_int8_records=sum("[int8]" in ln for ln in tiered),
         tiered_last=tiered[-1])


KERNELS = {
    # name: (source, the Pallas function it replaces, row of the int8
    # phase at the main path's most frequent shape)
    "quantize_rowwise": ("src/repro_torch/csrc/quantized.cu",
                         "src/repro/kernels/quantized.py:64",
                         "quantize_64x312"),
    "dequantize_rowwise": ("src/repro_torch/csrc/quantized.cu",
                           "src/repro/kernels/quantized.py:89",
                           "dequantize_1x312"),
    "int8_matmul": ("src/repro_torch/csrc/quantized.cu",
                    "src/repro/kernels/quantized.py:123",
                    "gemm_64x312x936"),
}


def _line(name, source, replaces, launches, row, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **extra}


def main():
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernel()
    int8_rows = phase_int8()
    serve_launches = phase_serve()
    tiered_launches = phase_tiered()
    phase_cli()
    emit("done", seconds=time.perf_counter() - t0)
    print(smi)
    kernels = [_line("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:98",
                     serve_launches, rows["per_event"],
                     launches_by_path={
                         "serve": serve_launches,
                         "tiered": tiered_launches["flash_attention"]})]
    for name, (source, replaces, row) in KERNELS.items():
        kernels.append(_line(name, source, replaces, tiered_launches[name],
                             int8_rows[row], shape=int8_rows[row]["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
