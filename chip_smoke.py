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
  cli     the launcher's default command on the card.

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
TOL = 1e-4          # kernel vs plain version, float32 on the card
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


def phase_cli():
    from repro_torch.launch.serve import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--episode", "2", "--mobility", "--crash-edge-at", "12"])
    lines = buf.getvalue().strip().splitlines()
    check(lines[-1].startswith("cumulative serving time") and
          lines[-1].endswith("on cuda"), f"unexpected cli output {lines[-1:]}")
    check(sum("protocol=" in ln for ln in lines) > 0, "cli served nothing")
    emit("cli", lines=len(lines), last=lines[-1])


def main():
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernel()
    launches = phase_serve()
    phase_cli()
    emit("done", seconds=time.perf_counter() - t0)
    main_row = rows["per_event"]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:98",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
