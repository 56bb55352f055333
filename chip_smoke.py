#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device  the card, its power limit, the software versions; TF32 off.
  build   every kernel under src/repro_torch/csrc built with nvcc; the
          registers and spills ptxas reports for the tensor-core flash
          instantiations and the scan's, and the HMMA instructions
          cuobjdump finds in the flash kernels (each tensor-core one must
          hold some).
  kernel  the CUDA flash-attention kernel against its plain PyTorch
          version on the card, at the serving shapes (TinyBERT, BERT-base
          and MobileBERT per event, a padded batch, the S=512 segments
          buffer, BERT-base at B=8 S=128; the flush path's bucketed
          batches, B=16 at S=32 and 64 with ragged lengths, and its packed
          T=1024 buffer of the batch phase's 16 text rows), causal GQA
          with a window, and the LLM zoo's bf16 prefill (B=1 S=512 D=128
          causal at Mistral-NeMo's 32 heads over 8, OLMoE's 16 over 16,
          and Mistral's with a 128-token window; fp16 at OLMoE's, and
          bf16 at D=26 with kv_lengths, rows off 16 bytes, bf16 segment
          ids over the S=512 buffer at D=64 and bf16 causal GQA with
          Sq=100 < Sk=300; these on the tensor-core kernel, path "mma"): max |diff| <= 1e-4 (bf16,
          fp16: one step of the type at the output's scale), exact zeros
          on fully masked rows, one launch counted per call, the same
          under every tile plan the kernel compiles for the type (each
          timed); times of the kernel, the plain
          version and F.scaled_dot_product_attention (a yardstick only:
          the port never calls it), and the least time the card could
          take for the same work.
  serve   EMSNet TinyBERT-GRU-FC served per event by EMSServe on Table-6
          episodes 1-3 (adaptive offload under mobility, an edge crash in
          episode 2): the kernel must be launched exactly layers x
          text-consuming models x text events times, every recommendation
          finite, and the same episodes on the CPU (plain versions, the
          same profile table) must pick the same model, tier and cache
          hits, with outputs within 1e-4.
  bertbase  Table-6 episode 1 served per event with the BERT-base text
          encoder (12 layers of 12 heads of 64): flash launches ==
          layers x text-consuming models x text events, every
          recommendation finite.
  int8    the launch floor (torch.cuda._sleep(0), timed as the kernels
          are), then the CUDA quantize, dequantize and int8 GEMM kernels
          against their plain PyTorch versions on the card at every shape
          the tiered int8 path gives them, plus every form of the quantize
          kernel's plan (rows off 16 bytes, a block a row at the rows
          form's cap K=2048, K=4100 over it, M=130, a strided view),
          all-zero rows among .5 ties at K=8 and K=1200 (row-major and as
          a transposed view), dequantize at K % 4 != 0 and K=4100, and
          (33,100)x(100,130): bit-equal, one launch counted per call.
          Times of kernel, plain version
          and, where one PyTorch call computes the same function, that
          call (torch._int_mm for the GEMM's integer product, q * scale
          for dequantize), and the bound; two quantized_matmul rows
          (quantize then the GEMM, timed as one call).
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
  robust  the tiered cell (same widths, zoo, sessions, tiers, precision
          map, links and profile table as the tiered phase) under its
          robustness rungs: (i) speculation, every adaptive arrival
          racing (deadline 0, margin 0) and again at the launcher's 350 /
          50 ms; (ii) re-dispatch with edge64x crashed inside one of its
          flights; (iii) chaos_schedule(5) over ph1 and edge64x with
          re-dispatch and the launcher's speculation. Each drive against a
          CPU run of the same engine, table, payloads and faults: records
          (placement fields, speculative, race_winner exact; t_emit and
          race_loser_emit within 1e-9; outputs within 1e-4 or INT8_TOL),
          speculation_stats() equal, at least one race in (i), one
          re-dispatch in (ii), one rejoin in (iii); flash launches ==
          layers x text encodes == the CPU run's calls, the int8 kernels'
          launches == the CPU run's calls; the card's trace event for
          event the CPU run's (name, cat, track, args; times within one
          export rounding, 1e-9 s), passing the port's auditor, (i)'s
          StreamingTracer JSONL (chiprun_out/robust_race.jsonl) auditing
          as the CPU run's in-memory export; the graph checks. Reports
          per-arrival wall p50/p99 graphed and eager, races and winners,
          the card's busy share over (i) and the tracer's cost per arrival
          (drive (i) with Tracer.disabled against an in-memory Tracer and
          the StreamingTracer, ten rounds in turns, median and quartiles
          of the differences).
  batch   the EMSServeEngine flush path at the launcher's TinyBERT-GRU-FC
          width, 16 sessions with their own payload lengths (text 8-64
          tokens, vitals 5-30 steps, numpy seed 0): (i) 'batch' over
          Table-6 episodes, (ii) the same ragged, (iii) 'batch+stream'
          over the mix scenario (sim_window 0.05 s), bucketed and ragged
          with grouped tails, (iv) 'stream+tiered', 4 sessions of mix on
          glass/ph1/edge64x with ph1=int8,edge64x=int8. Each run is held
          against a CPU run of the same engine and payloads: the same
          flushes, encoder and tail calls, (sid, step, model, kind) of
          every prediction, outputs within 1e-4 (INT8_TOL where the fusion
          read an int8 feature; t_emit within 1e-9 in (iv)). Flash
          launches == the CPU run's calls == layers x text encoder calls;
          the int8 kernels' launches == the CPU run's calls; at most one
          synchronising call flagged per warm flush; ragged within 1e-4 of
          bucketed on the card; a grouped tail fusing several sessions;
          at least one glass partial in (iv). Reports per-flush wall and
          per-arrival latency p50/p99, the card's busy share, the padded
          FLOP fraction, the live bucket and packed shapes, and one
          flush of 16 sessions' text or vitals, bucketed against ragged.
  fleet   the region simulator (repro_torch.fleet) at the launcher's
          TinyBERT-GRU-FC width over the 7-model zoo, parameters placed
          through the sharding policy (63 leaves, 6 with a 'model' spec):
          (i) two replicas admitting every session of
          generate_workload(8, 2, seed=0, time_scale=0.2) with the parity
          bucket (batch_bucket_min=2, max_coalesce=2) on a step clock
          (1 ms a time_fn() call), against a CPU run: routes, flush log,
          TTFP, time-to-final, report and merged Prometheus text equal,
          finals within 1e-4 of the CPU's and of the card's own per-event
          engine, flash launches == the CPU run's calls == layers x text
          encodes; (i') the same at 50 ms a call against an 80 ms
          admission deadline (flushes coalesce, the router spills, part of
          the load sheds), held alike; (ii) the same drive shedding every
          session to the glass path (deadline 1e-4 s): degraded partials
          only, t_emit equal to the CPU's, partials within 1e-4, launches
          == the CPU's calls, the StreamingTracer's
          chiprun_out/fleet_shed.jsonl clean to the auditor; (iii) benchmarks/fleet_load.py's method on the real
          clock, graphed, each point warmed by the identical drive: light
          and saturated calibration on one replica, the load curve over two
          replicas at 0.25-2x the saturated capacity (TTFP p50/p95/p99,
          finalized sessions/s, events per flush, captures in the measured
          pass: 0), shed-vs-queue at 2x the knee with the knee's p99 as
          deadline, weak scaling over 1, 2 and 4 replicas, and the card's
          busy share over the knee point; offered == admitted + shed and
          degraded-only partials at every point. Speed is printed, not
          asserted.
  train   EMSNet multitask training on the card (repro_torch.training)
          on the port's synthetic NEMSIS data at the launcher's sizes
          (D1 8000 samples, D2 600 3-modal, vocab 2048). TinyBERT-GRU-FC:
          the first 5 AdamW steps at B=64 from one CPU-drawn model on card
          and CPU, losses within rtol 1e-4; the reference's directional
          claims at full width (200 steps of text+vitals: last-10 mean
          loss under 0.7x the first 10; text+vitals protocol top-1 above
          vitals-only's by more than 0.15 after 200 steps each; PMI on D2,
          100 steps at B=32, at or above scratch 3-modal training's top-1);
          PMI's frozen text and vitals encoders bit-identical; 0 flash
          calls over all of it; an {"m2", "m3"} checkpoint restored into a
          fresh template on the card, bit-equal; the 3-modal test split
          through the flash kernel's segment mode (the data's PAD holes
          rule out the kv_lengths mode, whose distance is reported) within
          1e-4 of the einsum evaluation, the same top-1 wherever the top
          two logits are 1e-3 apart, launches == layers x batches; Table-6
          episode 1 served per event with the restored weights (launches
          == layers x text models x text events, every recommendation
          finite). BERT-base: 2 steps at B=8 card vs CPU (rtol 1e-4), then
          20 steps at B=64 (loss falls, finite). For both widths: ms per
          step p50/p99 (steps after the first 3, each synchronised),
          samples/s, the card's busy share of 3 profiled steps, peak
          memory and the 6N FLOP bound at 67 TFLOP/s float32.
  decode_kernel  the CUDA decode-attention kernel against its plain
          version on the card: tests/test_decode_kernel.py's shapes x
          windows 0/24 (float32, 3e-5), a small bf16 case, Mistral-NeMo's
          full-width decode (B=1, W=1024, H=32, KV=8, D=128, bf16; half
          filled, and wrapped at t=1500 with a 512 window) and OLMoE's
          (H=16, KV=16, half filled), each within one
          bf16 step of the plain result, and a cache with no valid slot
          (the mean of v); times of kernel, plain version and
          F.scaled_dot_product_attention (a yardstick only), each with the
          L2 cache flushed before the call (as a decode step finds it) and
          warm, and the bound.
  rwkv_kernel  the CUDA RWKV6 scan against its plain version on the card:
          tests/test_kernels.py's shapes (1e-4), the chained-state contract,
          RWKV6-1.6B's full width (B=1, H=32, n=64, nonzero s0) at S=520
          and S=1 (1e-4 of the output's scale), with decays in (0.4, 0.9)
          and as the model draws them, and a small scan whose decays hold
          exact 0s and 1s; every case under each chunk length the kernel
          compiles (each timed); times (L2 flushed, and warm) and the
          bound. r, k and v in bf16 (as the bf16 model passes them) at
          S=520 and S=1 of that width, and in fp16 with rows off 16 bytes:
          bit for bit the float32 launch on the up-cast inputs under each
          chunk length, timed beside it and beside three casts to float32
          followed by the float32 launch.
  llm     the prefix-cached LLMServer. (i) Every ported arch reduced to 2
          float32 layers on examples/llm_generate.py's mix, card vs CPU:
          the same tokens and stats, logits of every call within 1e-4, a
          prefix hit's tokens equal to a cold server's. (ii) mistral-nemo-12b,
          rwkv6-1.6b and olmoe-1b-7b (MoE) at full width in bf16, one at a
          time: a 512-token system prompt, 4 hits of it + 8 tokens (16 new
          tokens each), one cold 520-token request, cache_len 1024: 4/4
          hits, the stats the mix implies, decode attention launched
          layers x decode steps and the scan layers x (prefills + decode
          steps) times, finite logits; an eager server (the system prompt
          and its first hit) gives the same tokens, and two of its layer
          inputs are held against the plain version; for Mistral and
          OLMoE, prefill(kernel="pallas") on the cold prompt against
          kernel="jnp": the flash kernel launched once a layer, each
          layer's output within one bf16 step of the plain version's on
          its own inputs, the logits within 4 bf16 steps of their scale
          (PALLAS_PREFILL_STEPS) and the same greedy token; for RWKV6, the
          scan's inputs captured from the eager server in bf16 and bit for
          bit its float32 launch on them up-cast, and the cold prompt's
          prefill plus 8 greedy steps with r/k/v passed as bf16 against
          the same with them up-cast first: logits bit for bit, the same
          tokens, both prefill walls; reports prefill and per-token
          decode wall, graphed and eager, tokens/s, peak memory, the
          weight-read bound (OLMoE's
          active-parameter bound beside it) and the card's busy share
          under the profiler. (iii) codeqwen1.5-7b, nemotron-4-15b and
          qwen1.5-32b (35.2 B parameters, 70.4 GB) at full width and
          depth in bf16 with a trimmed mix: the system prompt, one hit, the
          cold request, graphed, then a hit with every step synchronised:
          stats, launches, plateau; tokens/s, per-token p50/p99, peak
          memory.
  cli     the launcher's default command, its tiered int8 command, the
          robust command (--speculate --redispatch --chaos-seed 5 --trace
          chiprun_out/robust_trace.json --metrics-out
          chiprun_out/robust.prom) followed by python -m
          repro_torch.obs.audit on its trace (exit 0), its
          flush-path commands (--engine batch; batch+stream --ragged;
          stream --wall-clock --deadline-ms 50 --speed 5), each printing a
          CUDA graph count, python -m repro_torch.launch.llm_generate
          (one line and one decode graph an arch), the fleet (--fleet 4 --replicas 2
          --sessions 12 --trace chiprun_out/fleet_trace.jsonl --metrics-out
          chiprun_out/fleet.prom: the summary ends on cuda, the trace
          audits clean) and --batched 8 with its deprecation note, and
          python -m repro_torch.launch.train
          --steps 20 --d1-size 2000 (D1 pretraining, 50 PMI steps, both
          evaluations, a checkpoint in a temporary directory), on the
          card.

Graphs: the path phases (serve, bertbase, tiered, robust, batch, llm) serve
through the graphed pieces (``split(jit=True)``, the LLMServer's captured
decode step) and also check, for each drive: compile_count() on the card
== the CPU run's; a second pass of the drive captures nothing (its
flushes, and only they, counted for synchronising calls, since capturing
synchronises); every piece ran in Python only for its warm-up and its
capture; an eager run on the card (``jit=False``, an uncaptured server)
bit-equal to the graphed replays; the first pass's cached features byte
for byte unchanged after the second pass. Each reports eager and graphed
walls side by side, the captures, the seconds spent capturing and
torch.cuda.memory_reserved() before and after. The tiered cells' profile
tables are profiled from the eager pieces (``tier_table``).

The last lines are the card's name and power limit as nvidia-smi prints
them, the kernels' summary, and {"ok": true, "device": {...}}. Any failed
check raises, so the exit code is non-zero and no result line prints.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# traces and pages the run writes beside its log (git-ignored)
OUT_DIR = os.path.join(ROOT, "chiprun_out")
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM published peaks at its 700 W limit (NVIDIA data sheet, dense):
# HBM3 bandwidth and float32 outside the tensor cores, the unit the flash
# kernel computes on
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12     # bf16 and fp16 tensor cores, dense
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

CARD = {}     # nvidia-smi's name and power limit, printed beside the walls


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
    smi = CARD["nvidia_smi"] = smi.strip().splitlines()[0]
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi


# ----------------------------------------------------------------- build

def demangle(names):
    """C++ names as ``c++filt`` gives them, or as they are without it."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        got = out.stdout.splitlines()
        return got if out.returncode == 0 and len(got) == len(names) else names
    except OSError:
        return names


def ptxas_entries(log):
    """{entry function: {"registers", "spill_stores", "spill_loads"}} from
    ``nvcc -Xptxas -v``'s log."""
    entries, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
            entries[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            entries[cur].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            entries[cur]["registers"] = int(m.group(1))
    return dict(zip(demangle(list(entries)), entries.values()))


def sass_counts(lib, opcode):
    """{kernel: count of ``opcode`` in its SASS} from ``cuobjdump -sass``
    beside nvcc, or None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120).stdout
    counts, cur = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and re.search(rf"\b{opcode}\b", ln):
            counts[cur] += 1
    return dict(zip(demangle(list(counts)), counts.values()))


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
    # the tensor-core flash instantiations and the scan's per input type:
    # registers and spills, and HMMA instructions in the flash kernels
    entries = {}
    for name, r in report.items():
        entries.update({k: v for k, v in ptxas_entries(r["ptxas"]).items()
                        if "flash_mma_kernel" in k or "rwkv6_" in k})
    hmma = sass_counts(build._target(build.CSRC / "flash_attention.cu"),
                       "HMMA")
    emit("build_kernels", ptxas=entries,
         hmma=None if hmma is None else {k: n for k, n in hmma.items()
                                         if "flash" in k})
    if hmma is not None:
        check(all(n > 0 for k, n in hmma.items() if "flash_mma_kernel" in k)
              and any("flash_mma_kernel" in k for k in hmma),
              f"no HMMA in the tensor-core flash kernel: {hmma}")


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


_FLUSH = []


def device_ms_cold(fn, *, reps=25):
    """Median over ``reps`` of the card's time for one call, CUDA events
    around that call alone, with the 50 MB L2 cache flushed before it (a
    64 MB read): a decode step finds its KV cache and scan inputs cold,
    since a layer's weights stream through L2 between two calls. The
    call is queued behind a sleep kernel and the flush, so the host's
    launch overhead stays out of the reading."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(16 << 20, dtype=torch.float32, device="cuda"))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        _FLUSH[0].amax()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
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
    2 (D + Dv) FLOPs over the peak rate of the inputs' type (float32
    outside the tensor cores; bf16 and fp16 on them)."""
    B, Sq, _, D = q.shape
    Dv = v.shape[-1]
    pairs = int(mask.sum()) * H
    key_rows = int(mask.any(dim=1).sum())
    item = q.element_size()
    nbytes = item * (B * Sq * H * (D + Dv) + key_rows * KV * (D + Dv)) \
        + extra_bytes
    flops = 2 * (D + Dv) * pairs
    rate = FP32_FLOP_PER_S if q.dtype == torch.float32 else BF16_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes)


MANTISSA_BITS = {torch.bfloat16: 7, torch.float16: 10}


def step_of_scale(x, dtype=torch.bfloat16):
    """One step of ``dtype`` (bf16 unless given) at the size of ``x``'s
    largest element."""
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max())))
                   - MANTISSA_BITS[dtype])


def kernel_case(name, *, B, Sq, Sk, H, KV, D, causal=False, window=0,
                lengths=None, segments=None, block=128, fused_qkv=False,
                seed=0, dtype=torch.float32):
    """float32 cases (the FMA kernel) are held to TOL; bf16 and fp16 ones
    (the tensor-core kernel) to one step of their type at the output's
    scale (the kernel and the plain version both sum in float32 and round
    once; the sums run in another order, and the kernel's P is the sum of
    two roundings to the input type)."""
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    if fused_qkv:        # the text encoder's layout: views of one qkv buffer
        qkv = torch.randn((B, Sq, 3, H, D), generator=g).to(dev, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn((B, Sq, H, D), generator=g).to(dev, dtype)
        k = torch.randn((B, Sk, KV, D), generator=g).to(dev, dtype)
        v = torch.randn((B, Sk, KV, D), generator=g).to(dev, dtype)
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
    check(got.dtype == dtype, f"{name}: output {got.dtype}, not {dtype}")
    err = float((got.float() - want.float()).abs().max())
    tol = TOL if dtype == torch.float32 else step_of_scale(want, dtype)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(err <= tol, f"{name}: max |kernel - plain| = {err} > {tol}")
    dead = ~mask.any(dim=2)                     # (B, Sq) rows seeing no key
    n_dead = int(dead.sum())
    if n_dead:
        check(float(got[dead].abs().max()) == 0.0,
              f"{name}: fully masked rows are not exactly 0")

    kfn = lambda: FA.flash_attention(q, k, v, block_q=block, block_k=block, **kw)  # noqa: E731
    pfn = lambda: FA.flash_attention_plain(q, k, v, **kw)  # noqa: E731
    # every tile plan the kernel compiles for this type, on the same
    # inputs: each within tolerance of the plain version, each timed, so
    # the plan's pick is checked against the others (padding-free shapes
    # only: the plan sees S as is)
    by_block_q = {}
    plan = FA.plan_tiles(B, Sq, Sk, H, D, dtype)
    head_pad = plan[1]
    if dtype == torch.float32:
        # 128-row float32 blocks exist below head dim 128 only
        plans = [b for b in FA.BLOCK_Q if b < 128 or head_pad < 128]
    else:
        plans = list(FA.HALF_BLOCK_Q)
    if segments is None or Sq % block == 0:
        for bq in plans:
            afn = lambda bq=bq: FA._launch(  # noqa: E731
                q, k, v, causal=causal, window=window, scale=1.0 / math.sqrt(D),
                kv_lengths=kw.get("kv_lengths"),
                segment_ids=kw.get("segment_ids"), block_q=bq)
            alt = afn()
            torch.cuda.synchronize()
            a_err = float((alt.float() - want.float()).abs().max())
            check(a_err <= tol, f"{name}: block_q={bq}: max |kernel - plain| "
                  f"= {a_err} > {tol}")
            if n_dead:
                check(float(alt[dead].abs().max()) == 0.0,
                      f"{name}: block_q={bq}: masked rows are not exactly 0")
            by_block_q[bq] = {"max_abs_err": a_err, "ms": device_ms(afn)}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # a plain causal mask as is_causal, which lets SDPA take its flash
    # backend; any other mask as a boolean one
    plain_causal = causal and not window and lengths is None and Sq == Sk
    sdpa_kw = ({"is_causal": True} if plain_causal
               else {"attn_mask": mask[:, None]})
    if KV != H:
        sdpa_kw["enable_gqa"] = True
    lfn = lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)  # noqa: E731
    ms, plain_ms = device_ms(kfn), device_ms(pfn)
    # SDPA takes grouped kv heads from torch 2.5 on; else no yardstick
    gqa_ok = KV == H or tuple(map(int, torch.__version__.split(".")[:2])) >= (2, 5)
    library_ms = device_ms(lfn) if gqa_ok else None
    b_ms, b_by, flops, nbytes = bound(q, v, mask, H, KV, extra)
    row = dict(name=name, shape=dict(B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, D=D),
               dtype=str(dtype).split(".")[-1],
               path="fma" if dtype == torch.float32 else "mma",
               plan=plan, by_block_q=by_block_q,
               max_abs_err=err, tol=tol, zero_rows=n_dead, ms=ms,
               plain_ms=plain_ms,
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
    # BERT-base (d=768, 12 heads of 64) and MobileBERT (d=128, 4 heads of
    # 32) per event, as --text-encoder bertbase / mobilebert serve them
    rows["bertbase_per_event"] = kernel_case(
        "bertbase_per_event", B=1, Sq=64, Sk=64, H=12, KV=12, D=64,
        lengths=[64], fused_qkv=True, seed=5)
    rows["mobilebert_per_event"] = kernel_case(
        "mobilebert_per_event", B=1, Sq=64, Sk=64, H=4, KV=4, D=32,
        lengths=[64], fused_qkv=True, seed=6)
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
    seg_512 = seg
    rows["causal_gqa"] = kernel_case(
        "causal_window16_gqa", B=1, Sq=256, Sk=256, H=8, KV=2, D=64,
        causal=True, window=16, seed=3)
    rows["bertbase"] = kernel_case(
        "bertbase", B=8, Sq=128, Sk=128, H=12, KV=12, D=64,
        lengths=[128] * 8, fused_qkv=True, seed=4)
    # the flush path's shapes: a bucketed batch of 16 rows at the 32- and
    # 64-token text buckets, each row its own length; and the packed
    # buffer of the batch phase's 16 text rows (8-aligned, with gaps)
    for S in (32, 64):
        lens = rng.integers(1, S + 1, 16)
        lens[0] = S
        rows[f"batch16_s{S}"] = kernel_case(
            f"tinybert_batch16_s{S}", B=16, Sq=S, Sk=S, H=12, KV=12, D=26,
            lengths=lens.tolist(), fused_qkv=True, seed=7 + S)
    seg = packed_text_segments()
    rows["ragged"] = kernel_case(
        "tinybert_ragged_packed", B=1, Sq=seg.numel(), Sk=seg.numel(), H=12,
        KV=12, D=26, segments=[seg.tolist()], block=8, fused_qkv=True,
        seed=8)
    # the LLM zoo's prefill through prefill(kernel="pallas"), bf16: causal
    # GQA at Mistral-NeMo's heads, OLMoE's (MHA), and Mistral's with a
    # 128-token window, each over a 512-token prompt
    rows["mistral_prefill_bf16"] = kernel_case(
        "mistral_prefill_bf16", B=1, Sq=512, Sk=512, H=32, KV=8, D=128,
        causal=True, dtype=torch.bfloat16, seed=9)
    rows["olmoe_prefill_bf16"] = kernel_case(
        "olmoe_prefill_bf16", B=1, Sq=512, Sk=512, H=16, KV=16, D=128,
        causal=True, dtype=torch.bfloat16, seed=10)
    rows["window_prefill_bf16"] = kernel_case(
        "mistral_prefill_window128_bf16", B=1, Sq=512, Sk=512, H=32, KV=8,
        D=128, causal=True, window=128, dtype=torch.bfloat16, seed=11)
    # the half types' other load paths, on no served path: fp16 at
    # OLMoE's prefill, and bf16 rows off 16 bytes (D=26, views of a fused
    # qkv buffer, loaded element by element) with kv_lengths
    rows["olmoe_prefill_fp16"] = kernel_case(
        "olmoe_prefill_fp16", B=1, Sq=512, Sk=512, H=16, KV=16, D=128,
        causal=True, dtype=torch.float16, seed=12)
    rows["per_event_bf16"] = kernel_case(
        "tinybert_lengths_bf16", B=2, Sq=64, Sk=64, H=12, KV=12, D=26,
        lengths=[64, 0], fused_qkv=True, dtype=torch.bfloat16, seed=13)
    # the tensor-core kernel's other modes: segment ids over the packed
    # S=512 buffer (16-byte rows at D=64), and causal with Sq < Sk
    # (q_offset = Sk - Sq, a prefill continuing a cached prefix)
    rows["segments_bf16"] = kernel_case(
        "segments_d64_bf16", B=1, Sq=512, Sk=512, H=12, KV=12, D=64,
        segments=[seg_512.tolist()], block=8, fused_qkv=True,
        dtype=torch.bfloat16, seed=14)
    rows["causal_offset_bf16"] = kernel_case(
        "causal_q100_k300_gqa_bf16", B=1, Sq=100, Sk=300, H=8, KV=2, D=128,
        causal=True, dtype=torch.bfloat16, seed=15)
    return rows


# ----------------------------------------------------------------- serve

def run_episodes(splits, params, payloads, table, device, *, cached=True,
                 crash=(2, 12), episodes=(1, 2, 3)):
    from repro_torch.core import (AdaptiveOffloadPolicy, EMSServe,
                                  HeartbeatMonitor, table6)
    from repro_torch.launch.serve import _mobility_trace
    out = []
    for ep in episodes:
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


def device_time(fn, kernel_name, *, host_ops=True):
    """(the card's busy microseconds, the kernel's share of them, the
    profiled wall microseconds, the 6 largest device entries' shares of
    the busy time) over one call of ``fn``, from torch.profiler; (None,
    None, wall, {}) where the trace holds no device time.
    ``host_ops=False`` traces the card alone, which keeps a run of ~10^5
    small launches quick to reduce."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = ([ProfilerActivity.CPU] if host_ops else []) + \
        [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    total = kern = 0.0
    by_key = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        total += t
        by_key[e.key[:80]] = by_key.get(e.key[:80], 0.0) + t
        if kernel_name in e.key:
            kern += t
    if total <= 0:
        return None, None, wall_us, {}
    top = dict(sorted(((k, t / total) for k, t in by_key.items()),
                      key=lambda kv: -kv[1])[:6])
    return total, kern / total, wall_us, top


# ---------------------------------------------------------------- graphs
#
# Every path phase runs the graphed pieces (``split(jit=True)``, the
# LLMServer's captured decode step) and holds them to: the card's
# compile_count() == the CPU run's of the same drive; a second pass of
# the drive captures nothing; an eager run on the card (``jit=False``)
# bit-equal to the graphed replays; a feature the first pass committed
# byte for byte unchanged after the second pass's replays.

class Counted:
    """An encoder piece that counts its calls (the engine's encoder calls
    of one modality); its compile count reads through to the piece."""

    def __init__(self, fn, calls):
        self.fn, self.calls = fn, calls

    def __call__(self, p, x):
        self.calls[0] += 1
        return self.fn(p, x)

    def compile_count(self):
        from repro_torch.graphs import compile_count
        return compile_count(self.fn)


def graphed_pieces(splits):
    """The ``Graphed`` pieces of a {name: SplitModel} zoo."""
    from repro_torch.graphs import Graphed
    fns = [fn.fn if isinstance(fn, Counted) else fn
           for sm in splits.values()
           for fn in (*sm.encoders.values(), sm.tail, sm.full)]
    return [fn for fn in fns if isinstance(fn, Graphed)]


def captures(fns):
    """(graphs captured, host seconds spent capturing) over graphed
    pieces on the card."""
    return (sum(f.compile_count() for f in fns),
            sum(f.capture_s for f in fns))


def count_runs(g):
    """Count the Python runs of a ``Graphed`` piece's function in
    ``g.runs``: its warm-up and its capture, never a replay."""
    inner = g.fn

    def run(*a):
        g.runs += 1
        return inner(*a)
    g.runs, g.fn = 0, run
    return g


def fresh(splits, *, jit=True):
    """New pieces over the same modules, their Python runs counted: a
    path's own signatures counted from zero, or (``jit=False``) the eager
    pieces."""
    from repro_torch.core import split
    out = {k: split(sm.module, jit=jit) for k, sm in splits.items()}
    for g in graphed_pieces(out):
        count_runs(g)
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def cache_snapshot(cache):
    """A copy of every feature a feature cache holds."""
    return {k: [t.clone() for t in _tensors(e.feature)]
            for k, e in cache.entries()}


def check_cache_unchanged(cache, snap, what):
    """Every feature of ``snap`` still in ``cache``, byte for byte."""
    for (sess, m), want in snap.items():
        got = _tensors(cache.peek(sess, m).feature)
        check(len(got) == len(want)
              and all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{what}: cached feature {(sess, m)} changed after replays")
    return len(snap)


def graph_row(count, cpu_count, fns, first, mem_before, **extra):
    """Checks the compile count, the plateau (nothing captured since
    ``first``, the pieces' ``captures`` after the first pass) and that no
    piece ran in Python but for its warm-up and its capture; the row the
    phase emits."""
    n, _ = captures(fns)
    runs = sum(f.runs for f in fns)
    check(count == cpu_count and count > 0, f"compile_count {count} on the "
          f"card != {cpu_count} on the CPU (or 0)")
    check(n == first[0], f"a second pass of the drive captured "
          f"{n - first[0]} graphs")
    check(runs == 2 * n, f"the pieces ran {runs} times in Python for {n} "
          "captures: a piece ran eagerly after its warm-up")
    return dict(compile_count=count, cpu_compile_count=cpu_count,
                captures=first[0], capture_s=first[1],
                second_pass_captures=n - first[0], python_runs=runs,
                memory_reserved={"before": mem_before,
                                 "after": torch.cuda.memory_reserved()},
                **extra)


def same_records(a_recs, b_recs, what):
    """Per-event records: the same model, tier and cache hits; outputs bit
    for bit."""
    check(len(a_recs) == len(b_recs), f"{what}: record counts differ")
    for a, b in zip(a_recs, b_recs):
        check((a.model, a.tier, a.cache_hits) == (b.model, b.tier,
                                                  b.cache_hits),
              f"{what}: event {a.index} placed differently")
        check((a.recommendation is None) == (b.recommendation is None),
              f"{what}: recommendation presence differs")
        if a.recommendation is not None:
            for k in a.recommendation:
                check(torch.equal(a.recommendation[k], b.recommendation[k]),
                      f"{what}: event {a.index} {k} not bit-equal")


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
    splits = fresh(splits)                      # the path's own graphs
    mem0 = torch.cuda.memory_reserved()

    FA.flash_attention.launches = 0             # the main path starts here
    gpu = run_episodes(splits, params, payloads, table, "cuda")
    launches = FA.flash_attention.launches      # ... and ends here
    caps = captures(graphed_pieces(splits))

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

    # a second pass replays every graph and captures none; the first
    # pass's cached features stay as they were; episode 1 eagerly on the
    # card (jit=False) is bit-equal to its graphed replay
    snap = cache_snapshot(gpu[0]["engine"].cache)
    warm = run_episodes(splits, params, payloads, table, "cuda")
    check_cache_unchanged(gpu[0]["engine"].cache, snap, "serve")
    eager_splits = fresh(splits, jit=False)
    eager = [run_episodes(eager_splits, params, payloads, table, "cuda",
                          episodes=(1,))[0] for _ in range(2)]
    for run in eager:
        same_records(warm[0]["engine"].records, run["engine"].records,
                     "serve: graphed vs eager")
    graphs = graph_row(
        sum(sm.compile_count() for sm in splits.values()),
        sum(sm.compile_count() for sm in cpu_splits.values()),
        graphed_pieces(splits), caps, mem0, cached_features_checked=len(snap),
        episode1_event_ms={"graphed": _percentiles(warm[0]["event_s"]),
                           "eager": _percentiles(eager[1]["event_s"]),
                           "eager_first": _percentiles(eager[0]["event_s"])})

    # the same three episodes once more under the profiler; the busy share
    # is taken against the unprofiled warm run's wall time (the profiler
    # slows the host) and against the profiled run's own
    busy_us, share, prof_wall_us, top = device_time(
        lambda: run_episodes(splits, params, payloads, table, "cuda"),
        "flash_fwd_kernel")
    gpu_wall_us = 1e6 * sum(run["wall_s"] for run in warm)
    direct = run_episodes(splits, params, payloads, table, "cuda",
                          cached=False)
    ev_ms = sorted(1e3 * s for run in warm for s in run["event_s"])
    sim = {c: sum(run["engine"].cumulative_time() for run in runs)
           for c, runs in (("cached", warm), ("direct", direct))}
    wall = {c: sum(run["wall_s"] for run in runs)
            for c, runs in (("cached", warm), ("direct", direct))}
    emit("serve", config="tinybert-gru-fc vocab 2048", launches=launches,
         expected_launches=expected, text_events=text_events,
         recommendations=n_recs, cpu_max_abs_diff=max_diff,
         profile_s=table.base,
         episode_wall_s={run["episode"]: run["wall_s"] for run in warm},
         event_ms_p50=float(np.percentile(ev_ms, 50)),
         event_ms_p99=float(np.percentile(ev_ms, 99)),
         first_pass_event_ms=_percentiles([t for run in gpu
                                           for t in run["event_s"]]),
         graphs=graphs,
         flash_share_of_gpu_time=share, gpu_busy_us=busy_us,
         top_device_shares=top,
         gpu_busy_share_of_wall=(busy_us / gpu_wall_us if busy_us else None),
         gpu_busy_share_of_profiled_wall=(busy_us / prof_wall_us
                                          if busy_us else None),
         direct_over_cached_sim=sim["direct"] / sim["cached"],
         direct_over_cached_wall=wall["direct"] / wall["cached"],
         sim_s=sim, wall_s=wall)
    return launches


def phase_bertbase():
    """One Table-6 episode served per event with the BERT-base text
    encoder (12 layers, d=768, 12 heads of 64), as --text-encoder
    bertbase serves it: the flash kernel's launches counted on that path,
    every recommendation finite, the compile count equal to a CPU run's,
    a second pass capturing nothing, an eager run bit-equal."""
    from repro_torch.configs.emsnet import config
    from repro_torch.core import ProfileTable, profile
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import build_models, sample_payloads

    cfg = config(text_encoder="bertbase", vocab_size=2048)
    splits, params = build_models(cfg, seed=0, device="cuda")
    payloads = sample_payloads(cfg)
    table = ProfileTable(base=profile(splits["m3"], params["m3"], payloads,
                                      device="cuda"))
    splits = fresh(splits)
    mem0 = torch.cuda.memory_reserved()
    FA.flash_attention.launches = 0             # the path starts here
    runs = run_episodes(splits, params, payloads, table, "cuda",
                        episodes=(1,))
    launches = FA.flash_attention.launches      # ... and ends here
    caps = captures(graphed_pieces(splits))
    n_layers = cfg.text_dims[0]
    text_models = sum("text" in sm.modalities() for sm in splits.values())
    text_events = sum(r.modality == "text" for r in runs[0]["engine"].records)
    expected = n_layers * text_models * text_events
    check(text_events >= 1, "the episode served no text event")
    check(launches == expected, f"bertbase: flash kernel launched {launches} "
          f"times, expected {n_layers} layers x {text_models} models x "
          f"{text_events} text events = {expected}")
    n_recs = 0
    for r in runs[0]["engine"].records:
        if r.recommendation is not None:
            n_recs += 1
            for k, t in r.recommendation.items():
                check(bool(torch.isfinite(t).all()), f"bertbase: non-finite {k}")
    check(n_recs > 0, "bertbase: no recommendation was served")
    snap = cache_snapshot(runs[0]["engine"].cache)
    warm = run_episodes(splits, params, payloads, table, "cuda",
                        episodes=(1,))
    check_cache_unchanged(runs[0]["engine"].cache, snap, "bertbase")
    eager = run_episodes(fresh(splits, jit=False), params, payloads, table,
                         "cuda", episodes=(1,))
    same_records(warm[0]["engine"].records, eager[0]["engine"].records,
                 "bertbase: graphed vs eager")
    # the compile count of the same drive on the CPU (its weights drawn
    # there from the same seed)
    cpu_splits, cpu_params = build_models(cfg, seed=0, device="cpu")
    run_episodes(cpu_splits, cpu_params, payloads, table, "cpu",
                 episodes=(1,))
    graphs = graph_row(
        sum(sm.compile_count() for sm in splits.values()),
        sum(sm.compile_count() for sm in cpu_splits.values()),
        graphed_pieces(splits), caps, mem0, cached_features_checked=len(snap))
    ev_ms = sorted(1e3 * t for t in warm[0]["event_s"])
    emit("bertbase", config="bertbase-gru-fc vocab 2048", launches=launches,
         expected_launches=expected, text_events=text_events,
         recommendations=n_recs, episode_wall_s=warm[0]["wall_s"],
         event_ms_p50=float(np.percentile(ev_ms, 50)),
         event_ms_p99=float(np.percentile(ev_ms, 99)),
         first_pass_event_ms=_percentiles(runs[0]["event_s"]),
         eager_event_ms=_percentiles(eager[0]["event_s"]), graphs=graphs)
    del splits, params, cpu_splits, cpu_params
    torch.cuda.empty_cache()
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


def _bit_equal(name, got, want):
    """max |got - want| over the tuples' tensors; fails unless every
    tensor is bit-equal (same dtype and shape)."""
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
    return err


def int8_case(name, kernel, fn, plain, *, bound_args, library=None,
              plan=None):
    """One kernel call on the card against its plain version: bit-equal
    (max_abs_err is 0 then), exactly one launch counted; then times."""
    before = kernel.launches
    got = fn()
    torch.cuda.synchronize()
    check(kernel.launches == before + 1,
          f"{name}: launches {kernel.launches} != {before + 1}")
    err = _bit_equal(name, got, plain())
    b_ms, b_by, ops, nbytes = int8_bound(*bound_args)
    row = dict(name=name, kernel=kernel.__name__, shape=bound_args[1:],
               max_abs_err=err, ms=device_ms(fn), plain_ms=device_ms(plain),
               library_ms=device_ms(library) if library is not None else None,
               call_ms=call_ms(fn), bound_ms=b_ms, bound_by=b_by, ops=ops,
               bytes=nbytes)
    if plan is not None:
        row["plan"] = plan._asdict()
    emit("int8", **row)
    return row


def phase_int8():
    from repro_torch.kernels import ops as O
    from repro_torch.kernels import quantized as Q
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return (torch.randn(shape, generator=g) * 2.0).to(dev)

    # the launch floor: an empty kernel, timed as the kernels are
    floor_ms = device_ms(lambda: torch.cuda._sleep(0))
    emit("int8", name="launch_floor", kernel="torch.cuda._sleep(0)",
         ms=floor_ms)
    rows = {"launch_floor": {"ms": floor_ms}}

    def quant(name, x):
        M, K = x.shape
        plan = Q.plan_quantize(M, K, x.stride(0), x.stride(1),
                               Q._aligned16(x))
        rows[name] = int8_case(name, Q.quantize_rowwise,
                               lambda: Q.quantize_rowwise(x),
                               lambda: Q.quantize_rowwise_plain(x),
                               bound_args=("quantize", M, K), plan=plan)

    # activations of one int8 text layer, vitals, scene; packed features
    for M, K in ((64, 312), (64, 1200), (30, 6), (1, 3), (1, 312), (1, 64),
                 (1, 16), (33, 100)):
        quant(f"quantize_{M}x{K}", randn(M, K))
    # weights, once per sidecar: the rowwise kernel over the view w.T
    for K, N in ((312, 936), (312, 312), (312, 1200), (1200, 312), (6, 192),
                 (3, 16)):
        quant(f"quantize_colwise_{K}x{N}", randn(K, N).T)
    # every form's edges: rows off 16 bytes, a block a row at the rows
    # form's cap, K over it, a partial block, a strided view that is
    # neither rows nor columns
    quant("quantize_offset_64x312", randn(64, 313)[:, 1:])
    quant("quantize_2x2048", randn(2, 2048))
    quant("quantize_8x4100", randn(8, 4100))
    quant("quantize_130x312", randn(130, 312))
    quant("quantize_strided_40x100", randn(40, 200)[:, ::2])
    ties = torch.zeros((3, 8))
    ties[1] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5])
    quant("quantize_zero_rows_and_ties", ties.to(dev))
    q, s = Q.quantize_rowwise(ties.to(dev))
    check(q[1].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]
          and s[:, 0].tolist() == [1.0, 1.0, 1.0]
          and int(q[0].abs().max()) == 0 and int(q[2].abs().max()) == 0,
          f"ties/zero rows: q={q.tolist()} scale={s.tolist()}")
    # all-zero rows among rows of .5 ties at K = 1200 (the w2 input's width)
    wide = torch.zeros((6, 1200))
    wide[1] = ties[1].repeat(150)
    wide[3] = -ties[1].repeat(150)
    wide[4] = torch.randn((1200,), generator=g)
    quant("quantize_zero_rows_and_ties_6x1200", wide.to(dev))
    quant("quantize_colwise_zero_cols_and_ties_1200x6", wide.T.contiguous()
          .to(dev).T)
    q, s = Q.quantize_rowwise(wide.to(dev))
    check(q[1, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]
          and q[3, :8].tolist() == [-127, 0, -2, -2, 0, 2, -126, 4]
          and [s[i, 0].item() for i in (0, 1, 2, 3, 5)] == [1.0] * 5
          and int(q[[0, 2, 5]].abs().max()) == 0,
          "ties/zero rows at K = 1200")

    def deq(name, qq, ss):
        M, K = qq.shape
        rows[name] = int8_case(
            name, Q.dequantize_rowwise,
            lambda: Q.dequantize_rowwise(qq, ss),
            lambda: Q.dequantize_rowwise_plain(qq, ss),
            library=lambda: torch.mul(qq, ss),
            bound_args=("dequantize", M, K))

    for M, K in ((1, 312), (1, 64), (1, 16), (33, 100), (5, 7), (64, 1200),
                 (2, 4100)):
        deq(f"dequantize_{M}x{K}", *Q.quantize_rowwise_plain(randn(M, K)))

    def gemm(key, xq, sx, wq, sw):
        (M, K), N = xq.shape, wq.shape[1]
        # torch._int_mm (the integer product alone) takes M > 16 and K, N
        # multiples of 8: the GEMM's yardstick where those rules allow
        lib = ((lambda: torch._int_mm(xq, wq))
               if M > 16 and K % 8 == 0 and N % 8 == 0 else None)
        rows[key] = int8_case(
            f"int8_matmul_{key[5:]}", Q.int8_matmul,
            lambda: Q.int8_matmul(xq, sx, wq, sw),
            lambda: Q.int8_matmul_plain(xq, sx, wq, sw), library=lib,
            bound_args=("gemm", M, K, N))

    # the tiered path's shapes, (33,100)x(100,130), then the tensor-core
    # tiles' edges: two row tiles and a tail (M = 130), exactly one
    # k-step and one n-group (64,32,8)
    for M, K, N in ((64, 312, 936), (64, 312, 312), (64, 312, 1200),
                    (64, 1200, 312), (30, 6, 192), (1, 3, 16),
                    (33, 100, 130), (130, 312, 312), (64, 32, 8)):
        xq, sx = Q.quantize_rowwise_plain(randn(M, K))
        wq, sw = Q.quantize_rowwise_plain(randn(N, K))
        gemm(f"gemm_{M}x{K}x{N}", xq, sx, wq.T.contiguous(), sw.reshape(1, N))
    # every entry +-127: the largest sums of either sign the guard allows
    sign = lambda *shape: (torch.randint(0, 2, shape, generator=g) * 254  # noqa: E731
                           - 127).to(torch.int8).to(dev)
    gemm("gemm_64x1200x312_pm127", sign(64, 1200), randn(64, 1).abs(),
         sign(1200, 312), randn(1, 312).abs())

    # what a text layer pays in situ: quantize then the GEMM, one call
    for M, K, N in ((64, 312, 936), (64, 1200, 312)):
        x = randn(M, K)
        wq, sw = O.quantize_colwise(randn(K, N) / math.sqrt(K))
        name = f"quantized_matmul_{M}x{K}x{N}"
        before = (Q.quantize_rowwise.launches, Q.int8_matmul.launches)
        got = O.quantized_matmul(x, wq, sw)
        torch.cuda.synchronize()
        check((Q.quantize_rowwise.launches, Q.int8_matmul.launches)
              == (before[0] + 1, before[1] + 1),
              f"{name}: not one launch of each kernel")

        def plain(x=x, wq=wq, sw=sw):
            return Q.int8_matmul_plain(*Q.quantize_rowwise_plain(x), wq, sw)

        err = _bit_equal(name, got, plain())
        rows[name] = dict(
            name=name, kernel="quantize_rowwise+int8_matmul",
            shape=[M, K, N], max_abs_err=err,
            ms=device_ms(lambda x=x, wq=wq, sw=sw: O.quantized_matmul(x, wq, sw)),
            plain_ms=device_ms(plain),
            parts_ms=rows[f"quantize_{M}x{K}"]["ms"]
            + rows[f"gemm_{M}x{K}x{N}"]["ms"])
        emit("int8", **rows[name])
    return rows


# ---------------------------------------------------------------- tiered

TIERED_PRECISION = {"ph1": "int8", "edge64x": "int8"}


def tiered_engine(splits, params, table, device, precision, *,
                  spec="tiered", sidecar_of=None, tracer=None, **rungs):
    """The slice's path as the launcher builds it: three tiers, the phone
    on a near-field tether, the glass<->edge link at 28 m NLOS (the
    low-uplink regime where quantized transport pays). ``sidecar_of``: an
    engine over the same weights whose int8 sidecar this one serves
    (a graph reads the sidecar's addresses, so a sidecar derived anew is
    a new signature). ``rungs``: ``speculation`` and ``redispatch``."""
    from repro_torch.core import BandwidthTrace, nlos_bandwidth
    from repro_torch.serving.api import build_engine
    eng = build_engine(
        splits, params, spec, share_encoders=True, max_history=None,
        device=device, profile=table, tiers=("glass", "ph1", "edge64x"),
        trace=BandwidthTrace.static(nlos_bandwidth(28.0)),
        tier_traces={"ph1": BandwidthTrace.static(nlos_bandwidth(0.0))},
        precision=precision, tracer=tracer, **rungs)
    if sidecar_of is not None:
        eng._qparams_cache.update(sidecar_of._qparams_cache)
    return eng


def tier_table(sm, params, payloads):
    """The tiered cells' profile table. The card stands for the fastest
    edge box (TIER_FACTORS 1.0): glass and phone times are the card's
    scaled by 107x and 23x. Profiled from the eager pieces, as the cells
    were defined: TIER_FACTORS scale an eager edge box to the paper's
    glass and phone. The graphed replays encode text ~5x faster, and at
    28 m NLOS every text flight then stays on the glass in float32, so
    the cell would no longer run the int8 text encoder (PERF.md §4)."""
    from repro_torch.core import ProfileTable, profile, split
    return ProfileTable(base=profile(split(sm.module, jit=False), params,
                                     payloads, device="cuda"),
                        host_tier="edge64x")


def serve_arrivals(eng, eps, payloads, *, crash_at=None, schedule=None):
    """Submit every arrival in global time order (after installing the
    crash or the chaos schedule); wall seconds of each, the card
    synchronised after it."""
    from repro_torch.core import merge_arrivals
    if crash_at is not None:
        eng.inject_crash(crash_at)
    if schedule is not None:
        eng.inject_schedule(schedule)
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


_TIER_TABLE = {}     # the tiered phase's profile table, for the robust phase


def int8_counters():
    from repro_torch.kernels import quantized as Q
    return (Q.quantize_rowwise, Q.dequantize_rowwise, Q.int8_matmul)


def reset_counts():
    from repro_torch.kernels import flash_attention as FA
    FA.flash_attention.launches = FA.flash_attention.calls = 0
    for k in int8_counters():
        k.launches = k.calls = 0


def phase_tiered():
    from repro_torch.configs.emsnet import config
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
    table = _TIER_TABLE["table"] = tier_table(splits[full], params[full],
                                              payloads)
    splits = fresh(splits)
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

    mem0 = torch.cuda.memory_reserved()
    reset_counts()                              # the main path starts here
    eng = tiered_engine(splits, params, table, "cuda", TIERED_PRECISION)
    first_walls = serve_arrivals(eng, eps, payloads, crash_at=crash_at)
    launches = {k.__name__: k.launches for k in int8_counters()}
    calls = {k.__name__: k.calls for k in int8_counters()}
    launches["flash_attention"] = FA.flash_attention.launches
    caps = captures(graphed_pieces(splits))                     # ... and ends here

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
    # on the CPU from the same seed, the ONE profile table; pieces of their
    # own, so the probe's signatures stay out of the count)
    reset_counts()
    cpu = tiered_engine(fresh(cpu_splits), cpu_params, table, "cpu",
                        TIERED_PRECISION)
    serve_arrivals(cpu, eps, payloads, crash_at=crash_at)
    cpu_calls = {k.__name__: k.calls for k in int8_counters()}
    check(all(k.launches == 0 for k in int8_counters()),
          "a CPU run launched a kernel")
    check(cpu_calls == calls, f"card launches {calls} != CPU calls "
          f"{cpu_calls}")
    diff = compare_runs(cpu, eng, "cpu vs cuda")

    # a second pass over the same weights (and the first engine's int8
    # sidecar) replays every graph and captures none; the first engine's
    # cached features stay as they were; an eager run on the card is bit
    # for bit the graphed replay
    snap = cache_snapshot(eng.cache)
    warm = tiered_engine(splits, params, table, "cuda", TIERED_PRECISION,
                         sidecar_of=eng)
    walls = serve_arrivals(warm, eps, payloads, crash_at=crash_at)
    wall_s = sum(walls)
    check_cache_unchanged(eng.cache, snap, "tiered")
    eager_splits = fresh(splits, jit=False)
    eager = tiered_engine(eager_splits, params, table, "cuda",
                          TIERED_PRECISION, sidecar_of=eng)
    eager_walls = serve_arrivals(eager, eps, payloads, crash_at=crash_at)
    compare_runs(warm, eager, "tiered: graphed vs eager", exact=True)
    graphs = graph_row(eng.compile_count(), cpu.compile_count(),
                       graphed_pieces(splits), caps, mem0,
                       cached_features_checked=len(snap),
                       arrival_ms={"graphed": _percentiles(walls),
                                   "eager": _percentiles(eager_walls),
                                   "first_pass": _percentiles(first_walls)})

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
    busy_us, _share, prof_wall_us, top = device_time(
        lambda: serve_arrivals(tiered_engine(splits, params, table, "cuda",
                                             TIERED_PRECISION, sidecar_of=eng),
                               eps, payloads, crash_at=crash_at),
        "int8_matmul_kernel")
    sm = splits[full]
    x = torch.as_tensor(payloads["text"], device="cuda")
    qparams = eng._quantized_params(full)
    text_ms = {}
    with torch.inference_mode():
        for how, enc in (("graphed", sm.encoders["text"]),
                         ("eager", eager_splits[full].encoders["text"])):
            text_ms[how] = {
                "fp32": call_ms(lambda: enc(params[full], x)),
                "int8": call_ms(lambda: quantize_feature(enc(qparams, x)))}
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
         gpu_busy_us=busy_us, top_device_shares=top,
         gpu_busy_share_of_wall=(busy_us / (1e6 * wall_s)
                                 if busy_us else None),
         gpu_busy_share_of_profiled_wall=(busy_us / prof_wall_us
                                          if busy_us else None),
         enc_text_call_ms=text_ms, graphs=graphs,
         feature_bytes={"raw": raw, "packed": packed},
         offloaded_int8_feature_bytes={"fp32": raw_b, "int8": packed_b},
         wire_shrink_x=(raw_b / packed_b if packed_b else None),
         links=eng.fabric.stats())
    return launches


# ---------------------------------------------------------------- robust

ROBUST_SPEC_MS = (350.0, 50.0)   # the launcher's --spec-deadline-ms / -margin-ms
# trace timestamps, card vs CPU: the simulated clocks agree within 1e-9 s
# (the in-order delivery's max against the reference's sum, one ulp), and
# the Chrome export rounds microseconds to 3 decimals, one more step
TRACE_TS_US = 2e-3


def _trace_events(doc):
    """(name, cat, track, ts us, dur us, args) of a Chrome trace doc's
    events, in program (seq) order."""
    tracks = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    evs = sorted((e for e in doc["traceEvents"] if e["ph"] != "M"),
                 key=lambda e: e["args"]["seq"])
    return [(e["name"], e["cat"], tracks[e["tid"]], e["ts"], e.get("dur"),
             e["args"]) for e in evs]


def _same_arg(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= 1e-9
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_arg(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_arg, a, b))
    return a == b


def same_trace(card_doc, cpu_doc, what):
    """The card's trace event for event the CPU run's: name, category,
    track and args equal (floats within 1e-9), times within one export
    rounding. Returns the event count."""
    a, b = _trace_events(card_doc), _trace_events(cpu_doc)
    check(len(a) == len(b) > 0, f"{what}: {len(a)} trace events on the "
          f"card, {len(b)} on the CPU")
    for x, y in zip(a, b):
        check(x[:3] == y[:3], f"{what}: trace event {x[:3]} != {y[:3]}")
        check(abs(x[3] - y[3]) <= TRACE_TS_US
              and (x[4] is None) == (y[4] is None)
              and (x[4] is None or abs(x[4] - y[4]) <= TRACE_TS_US),
              f"{what}: {x[:3]} at {x[3]}+{x[4]} us, CPU {y[3]}+{y[4]}")
        check(_same_arg(x[5], y[5]), f"{what}: {x[:3]} args {x[5]} != "
              f"{y[5]}")
    return len(a)


def compare_races(a_eng, b_eng, what):
    """The speculation fields of every record and the engines' race and
    fault statistics: the same."""
    for a, b in zip(a_eng.records, b_eng.records):
        check((a.speculative, a.race_winner) == (b.speculative,
                                                 b.race_winner)
              and (a.race_loser_emit is None) == (b.race_loser_emit is None)
              and (a.race_loser_emit is None
                   or abs(a.race_loser_emit - b.race_loser_emit) <= 1e-9),
              f"{what}: race fields differ at {_rec_key(a)}")
    stats = [(e.speculation_stats(), e.fallback_count, e.rejoin_count)
             for e in (a_eng, b_eng)]
    check(stats[0] == stats[1], f"{what}: statistics {stats[0]} != "
          f"{stats[1]}")


def edge_crash_with_redispatch(splits, params, table, eps, payloads):
    """A crash instant inside an edge64x encoder flight (the one nearest
    the middle of the run whose loss a re-dispatch takes), found from CPU
    runs: the timeline depends only on the table, traces and bytes."""
    probe = tiered_engine(splits, params, table, "cpu", TIERED_PRECISION)
    serve_arrivals(probe, eps, payloads)
    mid = probe.makespan_s() / 2
    flights = sorted((r for r in probe.records if r.enc_tier == "edge64x"
                      and r.t_emit > r.t_start),
                     key=lambda r: abs(r.t_start - mid))
    for r in flights[:6]:
        crash_at = (r.t_start + r.t_emit) / 2
        eng = tiered_engine(splits, params, table, "cpu", TIERED_PRECISION,
                            sidecar_of=probe, redispatch=True)
        serve_arrivals(eng, eps, payloads, crash_at=crash_at)
        if eng.redispatch_count:
            return crash_at
    raise AssertionError("no edge64x flight whose loss is re-dispatched")


def phase_robust():
    """The tiered cell under speculation, re-dispatch and chaos, each drive
    held against a CPU run of the same engine and faults."""
    from repro_torch.configs.emsnet import config
    from repro_torch.core import SpeculationPolicy, horizon
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import (build_zoo, sample_payloads,
                                          scenario_episodes)
    from repro_torch.obs import (StreamingTracer, Tracer, audit_doc,
                                 audit_file, jsonl_to_chrome)
    from repro_torch.serving.chaos import chaos_schedule

    cfg = config(text_encoder="tinybert", vocab_size=2048)
    full = "text+vitals+scene"
    base_splits, params = build_zoo(cfg, seed=0, device="cuda")
    cpu_base, cpu_params = build_zoo(cfg, seed=0, device="cpu")
    payloads = sample_payloads(cfg)
    table = (_TIER_TABLE.get("table")
             or tier_table(base_splits[full], params[full], payloads))
    eps = scenario_episodes(4, "mix")
    n_layers = cfg.text_dims[0]
    launcher_spec = SpeculationPolicy(deadline_s=ROBUST_SPEC_MS[0] / 1e3,
                                      margin_s=ROBUST_SPEC_MS[1] / 1e3)
    race_all = SpeculationPolicy(deadline_s=0.0, margin_s=0.0)
    crash_at = edge_crash_with_redispatch(cpu_base, cpu_params, table, eps,
                                          payloads)
    chaos = chaos_schedule(5, horizon=horizon(eps), tiers=("ph1", "edge64x"))
    os.makedirs(OUT_DIR, exist_ok=True)
    jsonl = os.path.join(OUT_DIR, "robust_race.jsonl")
    drives = {
        "race": dict(rungs={"speculation": race_all}),
        "race_350_50": dict(rungs={"speculation": launcher_spec}),
        "redispatch": dict(rungs={"redispatch": True}, crash_at=crash_at),
        "chaos": dict(rungs={"redispatch": True,
                             "speculation": launcher_spec}, schedule=chaos),
    }
    # the first engine on each side derives the int8 sidecar; every later
    # engine serves it, so no piece is captured again for a new address
    first, cpu_first = None, None
    rows, total = {}, {}
    for name, d in drives.items():
        rungs = d["rungs"]
        faults = {"crash_at": d.get("crash_at"),
                  "schedule": d.get("schedule")}
        splits = fresh(base_splits)
        tracer = (StreamingTracer(jsonl, buffer=256) if name == "race"
                  else Tracer())
        mem0 = torch.cuda.memory_reserved()
        reset_counts()                              # the main path starts here
        eng = tiered_engine(splits, params, table, "cuda", TIERED_PRECISION,
                            tracer=tracer, sidecar_of=first, **rungs)
        first_walls = serve_arrivals(eng, eps, payloads, **faults)
        launches = {k.__name__: k.launches for k in int8_counters()}
        calls = {k.__name__: k.calls for k in int8_counters()}
        launches["flash_attention"] = FA.flash_attention.launches
        calls["flash_attention"] = FA.flash_attention.calls
        caps = captures(graphed_pieces(splits))     # ... and ends here
        first = first or eng
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

        reset_counts()
        cpu_tracer = Tracer()
        cpu = tiered_engine(fresh(cpu_base), cpu_params, table, "cpu",
                            TIERED_PRECISION, tracer=cpu_tracer,
                            sidecar_of=cpu_first, **rungs)
        serve_arrivals(cpu, eps, payloads, **faults)
        cpu_first = cpu_first or cpu
        cpu_calls = {k.__name__: k.calls for k in int8_counters()}
        cpu_calls["flash_attention"] = FA.flash_attention.calls
        check(FA.flash_attention.launches == 0
              and all(k.launches == 0 for k in int8_counters()),
              f"{name}: a CPU run launched a kernel")

        recs = eng.records
        n_text = sum(r.modality == "text" for r in recs)
        ss = eng.speculation_stats()
        check(calls == launches, f"{name}: calls {calls} != launches "
              f"{launches} on the card")
        check(cpu_calls == launches, f"{name}: card launches {launches} != "
              f"CPU calls {cpu_calls}")
        check(launches["flash_attention"] == n_layers * n_text,
              f"{name}: flash launched {launches['flash_attention']} times, "
              f"expected {n_layers} x {n_text} text encodes")
        check(ss["races"] == sum(r.speculative for r in recs),
              f"{name}: {ss['races']} races counted for "
              f"{sum(r.speculative for r in recs)} racing records")
        if name == "race":
            check(ss["races"] >= 1 and all(
                      r.speculative for r in recs
                      if r.decision.best_remote is not None),
                  "race: an arrival with a remote in reach did not race")
        if name == "redispatch":
            check(ss["redispatches"] >= 1, "redispatch: no re-dispatch "
                  f"(edge64x crashed at {crash_at})")
        if name == "chaos":
            check(eng.rejoin_count >= 1, "chaos: no crash/rejoin cycle")
        for r in recs:
            if r.outputs is not None:
                for k, t in r.outputs.items():
                    check(bool(torch.isfinite(t).all()),
                          f"{name}: non-finite {k}")
        diff = compare_runs(cpu, eng, f"robust {name}: cpu vs cuda")
        compare_races(cpu, eng, f"robust {name}: cpu vs cuda")

        # the traces: event for event the CPU run's, clean to the auditor
        other = {"transport": eng.fabric.stats()}
        cpu_doc = cpu_tracer.to_chrome({"transport": cpu.fabric.stats()})
        if name == "race":
            tracer.close(other_data=other)
            card_doc = jsonl_to_chrome(jsonl)
            rep_file = audit_file(jsonl)
            check(rep_file.ok, f"race: the JSONL trace fails the audit: "
                  f"{rep_file.violations[:3]}")
            check(rep_file.checks == audit_doc(cpu_doc).checks,
                  f"race: JSONL audit {rep_file.checks} != the in-memory "
                  f"export's {audit_doc(cpu_doc).checks}")
        else:
            card_doc = tracer.to_chrome(other)
        rep = audit_doc(card_doc)
        check(rep.ok, f"{name}: the card's trace fails the audit: "
              f"{rep.violations[:3]}")
        check(audit_doc(cpu_doc).ok, f"{name}: the CPU trace fails the audit")
        n_events = same_trace(card_doc, cpu_doc, f"robust {name}")

        # graphs: a second pass captures nothing, cached features stay,
        # an eager run is bit for bit the graphed replay
        snap = cache_snapshot(eng.cache)
        warm = tiered_engine(splits, params, table, "cuda", TIERED_PRECISION,
                             sidecar_of=first, **rungs)
        walls = serve_arrivals(warm, eps, payloads, **faults)
        check_cache_unchanged(eng.cache, snap, f"robust {name}")
        eager = tiered_engine(fresh(base_splits, jit=False), params, table,
                              "cuda", TIERED_PRECISION, sidecar_of=first,
                              **rungs)
        eager_walls = serve_arrivals(eager, eps, payloads, **faults)
        compare_runs(warm, eager, f"robust {name}: graphed vs eager",
                     exact=True)
        compare_races(warm, eager, f"robust {name}: graphed vs eager")
        graphs = graph_row(eng.compile_count(), cpu.compile_count(),
                           graphed_pieces(splits), caps, mem0,
                           cached_features_checked=len(snap))
        rows[name] = dict(
            arrivals=len(recs), text_encodes=n_text, launches=launches,
            cpu_calls=cpu_calls, races=ss["races"], wins=ss["wins"],
            crash_saves=ss["crash_saves"], redispatches=ss["redispatches"],
            cancelled_msgs=ss["cancelled_msgs"],
            fallbacks=eng.fallback_count, rejoins=eng.rejoin_count,
            placement=eng.placement_counts(),
            int8_flights=sum(r.precision == "int8" for r in recs),
            cpu_max_abs_diff=diff, trace_events=n_events,
            audit=rep.checks,
            arrival_ms={"graphed": _percentiles(walls),
                        "eager": _percentiles(eager_walls),
                        "first_pass": _percentiles(first_walls)},
            sim_total_latency_s=eng.total_latency_s(), graphs=graphs,
            **({"crash_at": crash_at} if name == "redispatch" else {}),
            **({"schedule": [[e.tier, e.crash_at, e.rejoin_at]
                             for e in chaos]} if name == "chaos" else {}))
        emit("robust_drive", drive=name, card=CARD["nvidia_smi"],
             **rows[name])

    # reported, not asserted: the card's busy share over drive (i), and
    # the tracer's cost per arrival (drive (i), warm graphs, untraced
    # against the StreamingTracer, alternating)
    race_splits = fresh(base_splits)
    serve_arrivals(tiered_engine(race_splits, params, table, "cuda",
                                 TIERED_PRECISION, sidecar_of=first,
                                 speculation=race_all), eps, payloads)
    busy_us, _share, prof_wall_us, top = device_time(
        lambda: serve_arrivals(tiered_engine(
            race_splits, params, table, "cuda", TIERED_PRECISION,
            sidecar_of=first, speculation=race_all), eps, payloads),
        "flash_attention")
    # ten rounds in turns, each a whole drive's mean wall an arrival;
    # the cost is the median of the rounds' differences
    arms = ("disabled", "memory", "streaming")
    rounds = {k: [] for k in arms}
    scratch = os.path.join(OUT_DIR, "robust_tracer_cost.jsonl")
    for i in range(10):
        for how in (arms if i % 2 == 0 else arms[::-1]):
            tr = {"disabled": None, "memory": Tracer(),
                  "streaming": StreamingTracer(scratch, buffer=256)}[how]
            e = tiered_engine(race_splits, params, table, "cuda",
                              TIERED_PRECISION, sidecar_of=first, tracer=tr,
                              speculation=race_all)
            rounds[how].append(statistics.mean(
                serve_arrivals(e, eps, payloads)))
            if how == "streaming":
                tr.close(other_data={"transport": e.fabric.stats()})
    cost = {k: sorted(1e3 * (x - d) for x, d in zip(rounds[k],
                                                     rounds["disabled"]))
            for k in ("memory", "streaming")}
    emit("robust", config="tinybert-gru-fc vocab 2048, 7-model zoo",
         card=CARD["nvidia_smi"], sessions=4, drives=list(rows),
         crash_at=crash_at,
         gpu_busy_us=busy_us, top_device_shares=top,
         gpu_busy_share_of_profiled_wall=(busy_us / prof_wall_us
                                          if busy_us else None),
         tracer_ms_per_arrival={k: 1e3 * statistics.median(v)
                                for k, v in rounds.items()},
         tracer_cost_ms_per_arrival={k: statistics.median(v)
                                     for k, v in cost.items()},
         tracer_cost_quartiles_ms={k: statistics.quantiles(v, n=4)[::2]
                                   for k, v in cost.items()},
         launches=total)
    return total


# ----------------------------------------------------------------- batch

BATCH_SESSIONS = 16
BATCH_SEED = 0


def batch_payloads(cfg, n=BATCH_SESSIONS, seed=BATCH_SEED):
    """Each session's own payloads, drawn with numpy: text of 8-64
    tokens, vitals of 5-30 steps, a scene vector. Several length buckets
    are live and the packed buffers have gaps."""
    rng = np.random.default_rng(seed)
    text_len = rng.integers(8, cfg.max_text_len + 1, n)
    vitals_len = rng.integers(5, cfg.vitals_len + 1, n)
    return {f"s{i}": {
        "text": rng.integers(1, cfg.vocab_size,
                             (1, int(text_len[i]))).astype(np.int32),
        "vitals": rng.normal(size=(1, int(vitals_len[i]),
                                   cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32)}
        for i in range(n)}


def packed_text_segments():
    """Row ids of the buffer the ragged layout packs from the batch
    phase's 16 text rows (rows at 8-aligned offsets, gaps and tail -1)."""
    from repro_torch.configs.emsnet import config
    from repro_torch.core import RaggedBatch
    cfg = config(text_encoder="tinybert", vocab_size=2048)
    rows = [p["text"] for p in batch_payloads(cfg).values()]
    return RaggedBatch(max_lengths={"text": cfg.max_text_len}).pack(
        "text", rows)["row_ids"]


def counted_encoders(splits, modality):
    """Wrap every model's ``modality`` encoder with a call counter (the
    engine's encoder calls of that modality); returns the counter."""
    calls = [0]
    for sm in splits.values():
        if modality in sm.encoders:
            sm.encoders[modality] = Counted(sm.encoders[modality], calls)
    return calls


def flush_engine(spec, splits, params, device, cfg, **kw):
    """A flush-mode engine as the launcher builds one: its bucket grid,
    ``batch_bucket_min = min(8, sessions)``, session-level cache keys for
    stream specs."""
    from repro_torch.core import Bucketer
    from repro_torch.serving.api import build_engine
    return build_engine(
        splits, params, spec, device=device, max_history=None,
        bucketer=Bucketer(max_buckets={"vitals": cfg.vitals_len,
                                       "text": cfg.max_text_len}),
        batch_bucket_min=min(8, BATCH_SESSIONS),
        share_encoders="stream" in spec, **kw)


def count_syncs(fn):
    """Run ``fn`` under PyTorch's sync debug mode; the synchronising CUDA
    calls it warned about, as {"file:line" of the caller: count} (an
    explicit torch.cuda.synchronize is not among them)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    import linecache
    sites = {}
    for w in caught:
        line = linecache.getline(w.filename, w.lineno).strip()
        # turning the mode on is itself reported once, as a sync
        if "synchroniz" in str(w.message) and "sync_debug_mode" not in line:
            site = f"{os.path.basename(w.filename)}:{w.lineno} {line}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def _pred_rows(eng):
    return [p for f in eng.flushes for p in f.predictions]


def compare_flushes(a_eng, b_eng, what, tol=TOL, *, counts=True):
    """Flush for flush: the same counts (events, encoder and tail calls;
    events only without ``counts``) and the same (sid, step, model, kind)
    for every prediction; outputs within ``tol``. Returns the max
    |diff|."""
    check(a_eng.flushes_total == b_eng.flushes_total,
          f"{what}: {a_eng.flushes_total} != {b_eng.flushes_total} flushes")
    diff = 0.0
    for fa, fb in zip(a_eng.flushes, b_eng.flushes):
        ca = (fa.n_events, fa.n_encoder_calls, fa.n_tail_calls)
        cb = (fb.n_events, fb.n_encoder_calls, fb.n_tail_calls)
        if not counts:
            ca, cb = ca[:1], cb[:1]
        check(ca == cb, f"{what}: flush {fa.flush_id} counts {ca} != {cb}")
        ka = [(p.sid, p.step, p.model, p.kind) for p in fa.predictions]
        kb = [(p.sid, p.step, p.model, p.kind) for p in fb.predictions]
        check(ka == kb, f"{what}: flush {fa.flush_id} predictions differ")
        for pa, pb in zip(fa.predictions, fb.predictions):
            for k in pa.outputs:
                x, y = pa.outputs[k], pb.outputs[k].to(pa.outputs[k].device)
                check(bool(torch.isfinite(x).all()), f"{what}: non-finite")
                diff = max(diff, float((x - y).abs().max()))
    check(diff <= tol, f"{what}: outputs differ by {diff} > {tol}")
    return diff


def run_flush(eng, drive, *, syncs=False):
    """Drive ``eng`` with every counter at 0 first; returns the kernels'
    launches and calls and the synchronising calls counted (``syncs``)."""
    from repro_torch.kernels import flash_attention as FA
    reset_counts()                          # the path starts here
    sync_sites = count_syncs(lambda: drive(eng)) if syncs else None
    if not syncs:
        drive(eng)
    counts = {"flash_attention": (FA.flash_attention.launches,
                                  FA.flash_attention.calls)}
    for k in int8_counters():
        counts[k.__name__] = (k.launches, k.calls)
    return counts, sync_sites               # ... and ends here


def _percentiles(xs):
    ms = sorted(1e3 * x for x in xs)
    return {"p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99))} if ms else None


def compare_stream_tiered(a_eng, b_eng, what, *, exact=False):
    """stream+tiered card vs CPU: record and glass-partial placement and
    timelines (t_emit within 1e-9), outputs within 1e-4, or INT8_TOL where
    the fusion read an int8 feature, or bit-equal with ``exact``; the
    sessions' prediction streams the same model, step and kind. Returns
    (max diffs, glass partials)."""
    a_recs, b_recs = a_eng.records, b_eng.records
    check(len(a_recs) == len(b_recs), f"{what}: record counts differ")
    diff = {"fp32": 0.0, "int8": 0.0}
    latest, partials = {}, 0

    def cls_of(sid, mods):
        return ("int8" if any(latest.get((sid, m)) == "int8" for m in mods)
                else "fp32")

    def out_diff(cls, a_out, b_out):
        for k in a_out:
            x, y = a_out[k], b_out[k].to(a_out[k].device)
            check(bool(torch.isfinite(x).all()), f"{what}: non-finite {k}")
            if exact:
                check(torch.equal(x, y), f"{what}: {k} not bit-identical")
            diff[cls] = max(diff[cls], float((x - y).abs().max()))

    for a, b in zip(a_recs, b_recs):
        check(_rec_key(a) == _rec_key(b),
              f"{what}: {_rec_key(a)} != {_rec_key(b)}")
        check(abs(a.t_emit - b.t_emit) <= 1e-9
              and abs(a.t_start - b.t_start) <= 1e-9,
              f"{what}: timeline differs at {_rec_key(a)}")
        check((a.glass_partial is None) == (b.glass_partial is None),
              f"{what}: glass partial presence differs at {_rec_key(a)}")
        if a.glass_partial is not None:
            ga, gb = a.glass_partial, b.glass_partial
            check((ga.model, ga.step, ga.kind) == (gb.model, gb.step, gb.kind)
                  and abs(ga.t_emit - gb.t_emit) <= 1e-9,
                  f"{what}: glass partial differs at {_rec_key(a)}")
            out_diff(cls_of(a.sid, ga.modalities), ga.outputs, gb.outputs)
            partials += 1
        latest[(a.sid, a.modality)] = a.precision
        check((a.outputs is None) == (b.outputs is None),
              f"{what}: output presence differs")
        if a.outputs is not None:
            out_diff(cls_of(a.sid, a_eng.models[a.model].modalities()),
                     a.outputs, b.outputs)
    for sid in a_eng.sessions:
        ka = [(p.model, p.step, p.kind) for p in a_eng.sessions[sid].predictions]
        kb = [(p.model, p.step, p.kind) for p in b_eng.sessions[sid].predictions]
        check(ka == kb, f"{what}: {sid}'s predictions differ")
    check(diff["fp32"] <= TOL, f"{what}: fp32 outputs differ by "
          f"{diff['fp32']} > {TOL}")
    check(diff["int8"] <= INT8_TOL, f"{what}: int8 outputs differ by "
          f"{diff['int8']} > {INT8_TOL}")
    return diff, partials


def flush_walls(eng, payloads, modality, *, reps=5):
    """Median wall (ms, synchronised) of a flush in which every session
    submits one ``modality`` payload, after one warm flush."""
    from repro_torch.core import Event
    walls = []
    for r in range(reps + 1):
        for sid, pay in payloads.items():
            eng.submit(sid, Event(r, modality, float(r)), pay[modality])
        walls.append(eng.flush().wall_s)
    return 1e3 * statistics.median(walls[1:])


def phase_batch():
    """The flush path at the launcher's TinyBERT-GRU-FC width, on the card
    and on the CPU: (i) 'batch', 16 sessions of Table-6 episodes; (ii) the
    same, ragged; (iii) 'batch+stream' over the mix scenario, 16
    sessions, sim_window 0.05 s, bucketed and ragged (grouped tails);
    (iv) 'stream+tiered', 4 sessions of mix on glass/ph1/edge64x with
    ph1=int8,edge64x=int8. Each drive runs twice on the card over the
    same graphed pieces (the second pass captures nothing and flushes
    with no synchronising call but its own) and once eagerly."""
    from repro_torch.configs.emsnet import config
    from repro_torch.core import table6
    from repro_torch.launch.serve import (build_models, build_zoo,
                                          sample_payloads, scenario_episodes)

    cfg = config(text_encoder="tinybert", vocab_size=2048)
    n_layers = cfg.text_dims[0]
    pay = batch_payloads(cfg)

    def payload_fn(sid, ev):
        return pay[sid][ev.modality]

    table_eps = {f"s{i}": table6()[1 + i % 3] for i in range(BATCH_SESSIONS)}
    mix_eps = scenario_episodes(BATCH_SESSIONS, "mix")

    runs = {
        "batch": ("batch", build_models, False,
                  lambda e: e.run_episodes(table_eps, payload_fn)),
        "ragged": ("batch", build_models, True,
                   lambda e: e.run_episodes(table_eps, payload_fn)),
        "batch_stream": ("batch+stream", build_zoo, False,
                         lambda e: e.run_arrivals(mix_eps, payload_fn,
                                                  sim_window=0.05)),
        "batch_stream_ragged": ("batch+stream", build_zoo, True,
                                lambda e: e.run_arrivals(
                                    mix_eps, payload_fn, sim_window=0.05)),
    }
    out, engines, launches, built = {}, {}, {}, {}
    for name, (spec, models, ragged, drive) in runs.items():
        kw = {"deadline_s": None} if "stream" in spec else {}

        def engine(splits, params, device, spec=spec, ragged=ragged, kw=kw):
            return flush_engine(spec, splits, params, device, cfg,
                                ragged=ragged, **kw)

        splits, params = models(cfg, seed=0, device="cuda")
        splits = fresh(splits)
        text = counted_encoders(splits, "text")
        built[name] = (splits, params, engine)
        mem0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        eng = engine(splits, params, "cuda")
        counts, _ = run_flush(eng, drive)
        text_calls, caps = text[0], captures(graphed_pieces(splits))
        t1 = time.perf_counter()
        cpu_splits, cpu_params = models(cfg, seed=0, device="cpu")
        cpu_text = counted_encoders(cpu_splits, "text")
        cpu = engine(cpu_splits, cpu_params, "cpu")
        cpu_counts, _ = run_flush(cpu, drive)
        run_s = {"cuda": t1 - t0, "cpu": time.perf_counter() - t1}
        fl, fc = counts["flash_attention"]
        check(fl == fc, f"{name}: flash launches {fl} != calls {fc}")
        check(cpu_counts["flash_attention"] == (0, fl),
              f"{name}: card launched flash {fl} times, the CPU run called "
              f"it {cpu_counts['flash_attention'][1]} times (and launched "
              f"{cpu_counts['flash_attention'][0]})")
        check(text_calls == cpu_text[0] and fl == n_layers * text_calls,
              f"{name}: flash launches {fl} != {n_layers} layers x "
              f"{text_calls} text encoder calls (CPU {cpu_text[0]})")
        check(fl > 0, f"{name}: no flash launch")
        diff = compare_flushes(cpu, eng, f"{name}: cpu vs cuda")
        if ragged:
            check(max(f.n_encoder_calls for f in eng.flushes)
                  <= 3 * len(eng.models), f"{name}: more than one packed call "
                  "per modality and model")

        # the second pass: every graph replays, none is captured; the
        # flush's one explicit torch.cuda.synchronize is not flagged and
        # nothing else may wait for the card (capturing synchronises, so
        # only warm flushes are counted); the first pass's cached features
        # unchanged; an eager run bit-equal to the replays
        snap = cache_snapshot(eng.cache)
        warm = engine(splits, params, "cuda")
        warm_counts, sync_sites = run_flush(warm, drive, syncs=True)
        check(warm_counts == counts, f"{name}: the second pass launched "
              f"{warm_counts}, the first {counts}")
        check(not sync_sites, f"{name}: synchronising calls besides the "
              f"flush's own sync: {sync_sites}")
        check_cache_unchanged(eng.cache, snap, name)
        eager = engine(fresh(splits, jit=False), params, "cuda")
        run_flush(eager, drive)
        compare_flushes(warm, eager, f"{name}: graphed vs eager", tol=0.0)
        graphs = graph_row(
            eng.compile_count(), cpu.compile_count(),
            graphed_pieces(splits), caps, mem0,
            cached_features_checked=len(snap),
            flush_ms={"graphed": _percentiles([f.wall_s for f in warm.flushes]),
                      "eager": _percentiles([f.wall_s for f in eager.flushes]),
                      "first_pass": _percentiles([f.wall_s
                                                  for f in eng.flushes])},
            arrival_ms={"graphed": _percentiles(warm.event_latencies()),
                        "eager": _percentiles(eager.event_latencies())},
            total_flush_wall_s={"graphed": warm.total_wall_s(),
                                "eager": eager.total_wall_s()})
        engines[name] = warm
        launches[name] = fl
        out[name] = {
            "spec": spec, "ragged": ragged, "flushes": eng.flushes_total,
            "events": eng.events_total,
            "predictions": len(_pred_rows(eng)),
            "finals": sum(p.kind == "final" for p in _pred_rows(eng)),
            "encoder_calls": eng.encoder_calls_total(),
            "tail_calls": eng.tail_calls_total(),
            "text_encoder_calls": text_calls, "flash_launches": fl,
            "sync_calls_flagged": sync_sites, "cpu_max_abs_diff": diff,
            "run_seconds": run_s,
            "flush_ms": _percentiles([f.wall_s for f in warm.flushes]),
            "arrival_ms": _percentiles(warm.event_latencies()),
            "total_flush_wall_s": warm.total_wall_s(),
            "padded_flop_frac": float(np.mean([f.padded_flop_frac
                                               for f in eng.flushes])),
            "shapes": (eng.ragged.n_shapes() if ragged
                       else eng.bucketer.n_buckets()),
            "shape_histogram": {str(k): v for k, v in (
                eng.ragged.histogram if ragged
                else eng.bucketer.histogram).items()},
            "graphs": graphs}
        emit("batch", name=name, **out[name])

    # ragged against bucketed on the card: the same predictions, 1e-4
    for a, b in (("batch", "ragged"), ("batch_stream", "batch_stream_ragged")):
        d = compare_flushes(engines[a], engines[b], f"{a} vs {b} on the card",
                            counts=False)
        out[b]["vs_bucketed_max_abs_diff"] = d
    check(any(f.n_tail_calls == 1 and len(f.predictions) > 1
              for f in engines["batch_stream_ragged"].flushes),
          "no grouped tail fused more than one session")

    # flush walls of one modality across all 16 sessions, bucketed against
    # ragged (the ragged vitals scan runs its packed steps one by one),
    # graphed (the first flush captures, the median is over replays) and
    # eager
    t_walls = time.perf_counter()
    out["one_modality_flush_ms"] = {}
    for m in ("text", "vitals"):
        row = {}
        for name, key in (("batch", "bucketed"), ("ragged", "ragged")):
            splits, params, engine = built[name]
            row[key] = flush_walls(engine(splits, params, "cuda"), pay, m)
            row[f"{key}_eager"] = flush_walls(
                engine(fresh(splits, jit=False), params, "cuda"), pay, m)
        out["one_modality_flush_ms"][m] = row
    t_walls = time.perf_counter() - t_walls

    # the card's busy share over a window of (i) and (ii): the first 6
    # ticks (a text flush, then vitals and scene flushes) of a fresh
    # engine over the warm graphs, the card's kernels traced alone; the
    # wall it is read against is the same window's flushes unprofiled
    window = {sid: evs[:6] for sid, evs in table_eps.items()}
    t_prof = time.perf_counter()
    for name in ("batch", "ragged"):
        splits, params, engine = built[name]
        eng = engine(splits, params, "cuda")
        eng.run_episodes(window, payload_fn)
        plain_wall_s = eng.total_wall_s()
        eng = engine(splits, params, "cuda")
        busy_us, share, prof_wall_us, top = device_time(
            lambda: eng.run_episodes(window, payload_fn), "flash_fwd_kernel",
            host_ops=False)
        out[name].update(
            gpu_busy_us=busy_us, flash_share_of_gpu_time=share,
            top_device_shares=top,
            gpu_busy_share_of_profiled_wall=(busy_us / prof_wall_us
                                             if busy_us else None),
            gpu_busy_share_of_wall=(busy_us / (1e6 * plain_wall_s)
                                    if busy_us else None),
            profiled_seconds=time.perf_counter() - t_prof)
    seconds = {"one_modality_flushes": t_walls,
               "profiled_runs": time.perf_counter() - t_prof}
    del built
    t_iv = time.perf_counter()

    # (iv) stream+tiered: glass partials, int8 flights, card vs CPU
    full = "text+vitals+scene"
    splits, params = build_zoo(cfg, seed=0, device="cuda")
    table = tier_table(splits[full], params[full], sample_payloads(cfg))
    splits = fresh(splits)
    eps4 = scenario_episodes(4, "mix")

    def tiered(sp, pr, device, sidecar_of=None):
        return tiered_engine(sp, pr, table, device, TIERED_PRECISION,
                             spec="stream+tiered", sidecar_of=sidecar_of)

    walls4 = {}                         # id(engine) -> wall s per arrival

    def drive4(eng):
        from repro_torch.core import merge_arrivals
        walls = walls4[id(eng)] = []
        for _t, sid, ev in merge_arrivals(eps4):
            t0 = time.perf_counter()
            eng.submit(sid, ev, pay[sid][ev.modality])
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

    text = counted_encoders(splits, "text")
    mem0 = torch.cuda.memory_reserved()
    eng = tiered(splits, params, "cuda")
    counts, _ = run_flush(eng, drive4)
    text_calls, caps = text[0], captures(graphed_pieces(splits))
    cpu_splits, cpu_params = build_zoo(cfg, seed=0, device="cpu")
    cpu_text = counted_encoders(cpu_splits, "text")
    cpu = tiered(cpu_splits, cpu_params, "cpu")
    cpu_counts, _ = run_flush(cpu, drive4)
    for k, (launched, called) in counts.items():
        check(launched == called == cpu_counts[k][1]
              and cpu_counts[k][0] == 0,
              f"stream_tiered: {k} launched {launched} times, called "
              f"{called}, the CPU run called it {cpu_counts[k][1]} times")
    check(counts["flash_attention"][0] == n_layers * text_calls
          and text_calls == cpu_text[0],
          f"stream_tiered: flash {counts['flash_attention'][0]} != "
          f"{n_layers} x {text_calls} text encodes")
    check(counts["int8_matmul"][0] > 0, "stream_tiered: no int8 flight")
    diff, partials = compare_stream_tiered(cpu, eng, "stream_tiered: cpu "
                                           "vs cuda")
    check(partials >= 1, "stream_tiered: no glass partial")
    snap = cache_snapshot(eng.cache)
    warm = tiered(splits, params, "cuda", sidecar_of=eng)
    run_flush(warm, drive4)
    check_cache_unchanged(eng.cache, snap, "stream_tiered")
    eager = tiered(fresh(splits, jit=False), params, "cuda", sidecar_of=eng)
    run_flush(eager, drive4)
    compare_stream_tiered(warm, eager, "stream_tiered: graphed vs eager",
                          exact=True)
    graphs = graph_row(
        eng.compile_count(), cpu.compile_count(), graphed_pieces(splits),
        caps, mem0,
        cached_features_checked=len(snap),
        arrival_ms={"graphed": _percentiles(walls4[id(warm)]),
                    "eager": _percentiles(walls4[id(eager)]),
                    "first_pass": _percentiles(walls4[id(eng)])})
    launches["stream_tiered"] = counts["flash_attention"][0]
    out["stream_tiered"] = {
        "sessions": 4, "arrivals": len(eng.records),
        "glass_partials": partials,
        "predictions": sum(len(s.predictions) for s in eng.sessions.values()),
        "launches": {k: v[0] for k, v in counts.items()},
        "cpu_max_abs_diff": diff,
        "precision_counts": {p: sum(r.precision == p for r in eng.records)
                             for p in ("fp32", "int8")},
        "placement": eng.placement_counts(), "graphs": graphs}
    emit("batch", name="stream_tiered", **out["stream_tiered"])
    emit("batch_summary", config="tinybert-gru-fc vocab 2048",
         sessions=BATCH_SESSIONS,
         one_modality_flush_ms=out["one_modality_flush_ms"],
         profiled={name: {k: out[name][k] for k in (
             "gpu_busy_us", "flash_share_of_gpu_time", "top_device_shares",
             "gpu_busy_share_of_profiled_wall", "gpu_busy_share_of_wall",
             "profiled_seconds")}
             for name in ("batch", "ragged")},
         seconds={**seconds, "stream_tiered": time.perf_counter() - t_iv},
         ragged_vs_bucketed_flush_wall_s={
             k: (out[r]["total_flush_wall_s"], out[b]["total_flush_wall_s"])
             for k, b, r in (("batch", "batch", "ragged"),
                             ("batch_stream", "batch_stream",
                              "batch_stream_ragged"))})
    return launches


# ---------------------------------------------------------- decode_kernel

DECODE_TOL = 3e-5   # float32, tests/test_decode_kernel.py's tolerance
RWKV_TOL = 1e-4     # float32, tests/test_kernels.py's tolerance
BF16_BYTES = 2


def bf16_steps(got, want):
    """Largest |got - want| in bf16 steps of each element of ``want``."""
    w = want.float().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(w)) - 7)
    return float(((got.float() - want.float()).abs() / ulp).max())


def decode_bound(q, kbuf, valid):
    """Least time the card could take for one decode attention: q read and
    the output written once, and K and V of the slots these inputs need
    (the valid ones; all W when none is, since the result is then their
    mean) read once, over HBM bandwidth; against 4 D float32 operations
    per (query head, needed slot) (a score and its share of p @ v) over
    the peak rate of the inputs' type."""
    B, _, H, D = q.shape
    W, KV = kbuf.shape[1], kbuf.shape[2]
    need = int(valid.sum()) or W
    item = q.element_size()
    nbytes = 2 * B * H * D * item + 2 * B * need * KV * D * item + 4 * W
    ops = 4 * B * H * need * D
    rate = FP32_FLOP_PER_S if q.dtype == torch.float32 else BF16_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops, nbytes)


def ring_positions(W, t):
    """Slot positions of a ring of W slots after positions 0..t were
    written, slot = p % W."""
    pos = torch.full((W,), -1, dtype=torch.int32)
    p = torch.arange(max(0, t - W + 1), t + 1, dtype=torch.int32)
    pos[p % W] = p
    return pos


def decode_case(name, *, B, W, H, KV, D, t, pos, window=0,
                dtype=torch.float32, seed=0):
    from repro_torch.kernels import decode_attention as DA
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 1, H, D), generator=g).to(dev, dtype)
    k = torch.randn((B, W, KV, D), generator=g).to(dev, dtype)
    v = torch.randn((B, W, KV, D), generator=g).to(dev, dtype)
    pos = pos.to(dev)
    t_dev = torch.tensor(t, dtype=torch.int32, device=dev)
    valid = (pos >= 0) & (pos <= t)
    if window:
        valid &= t - pos < window
    before = DA.decode_attention.launches
    got = DA.decode_attention(q, k, v, pos, t_dev, window=window)
    torch.cuda.synchronize()
    check(DA.decode_attention.launches == before + 1,
          f"{name}: launches {DA.decode_attention.launches} != {before + 1}")
    want = DA.decode_attention_plain(q, k, v, pos, t_dev, window=window)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    row = dict(name=name, shape=dict(B=B, W=W, H=H, KV=KV, D=D, t=t,
                                     window=window),
               dtype=str(dtype).split(".")[-1], valid_slots=int(valid.sum()),
               max_abs_err=err)
    if dtype == torch.bfloat16:
        steps = bf16_steps(got, want)
        row["max_bf16_steps"] = steps
        check(steps <= 1.0, f"{name}: kernel {steps} bf16 steps from plain")
    else:
        check(err <= DECODE_TOL, f"{name}: max |kernel - plain| = {err} > "
              f"{DECODE_TOL}")
    if not bool(valid.any()):
        # no valid slot: the oracle's softmax weighs all W slots equally
        mean = v.float().mean(dim=1).repeat_interleave(H // KV, dim=1)
        mean_err = float((got.float()[:, 0] - mean).abs().max())
        row["max_abs_err_vs_mean"] = mean_err
        if dtype == torch.bfloat16:     # one rounding of the float32 mean
            steps = bf16_steps(got[:, 0], mean)
            row["max_bf16_steps_vs_mean"] = steps
            check(steps <= 1.0, f"{name}: all-invalid cache is {steps} "
                  f"bf16 steps from the mean of v")
        else:
            check(mean_err <= DECODE_TOL, f"{name}: all-invalid cache is "
                  f"{mean_err} from the mean of v")
    kfn = lambda: DA.decode_attention(q, k, v, pos, t_dev, window=window)  # noqa: E731
    pfn = lambda: DA.decode_attention_plain(q, k, v, pos, t_dev, window=window)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = valid[None, None, None, :]
    lfn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=KV != H)
    b_ms, b_by, ops, nbytes = decode_bound(q, k, valid)
    lib = bool(valid.any())             # SDPA has no all-masked row semantics
    row.update(ms=device_ms_cold(kfn), plain_ms=device_ms_cold(pfn),
               library_ms=device_ms_cold(lfn) if lib else None,
               ms_l2_warm=device_ms(kfn), plain_ms_l2_warm=device_ms(pfn),
               library_ms_l2_warm=device_ms(lfn) if lib else None,
               call_ms=call_ms(kfn), bound_ms=b_ms, bound_by=b_by, ops=ops,
               bytes=nbytes)
    emit("decode_kernel", **row)
    return row


def phase_decode_kernel():
    rows = {}
    # tests/test_decode_kernel.py's shapes: a ring with every 7th slot
    # never written, t = W + 5
    for B, W, H, KV, D in ((2, 64, 8, 4, 16), (1, 100, 4, 4, 32),
                           (2, 48, 8, 2, 64)):
        t = W + 5
        pos = torch.tensor([t - (s % (W + 3)) for s in range(W)],
                           dtype=torch.int32)
        pos[::7] = -1
        for window in (0, 24):
            name = f"decode_{B}x{W}x{H}x{KV}x{D}_w{window}"
            rows[name] = decode_case(name, B=B, W=W, H=H, KV=KV, D=D, t=t,
                                     pos=pos, window=window, seed=W + window)
    rows["bf16_small"] = decode_case(
        "decode_bf16_1x32x4x2x16", B=1, W=32, H=4, KV=2, D=16, t=31,
        pos=torch.arange(32, dtype=torch.int32), dtype=torch.bfloat16)
    # Mistral-NeMo-12B's decode: B=1, a 1024-slot ring, 32 heads over 8
    rows["mistral_half"] = decode_case(
        "decode_mistral_half_filled", B=1, W=1024, H=32, KV=8, D=128, t=511,
        pos=ring_positions(1024, 511), dtype=torch.bfloat16, seed=1)
    # OLMoE-1B-7B's decode: 16 heads over 16 (MHA), the same ring
    rows["olmoe_half"] = decode_case(
        "decode_olmoe_half_filled", B=1, W=1024, H=16, KV=16, D=128, t=511,
        pos=ring_positions(1024, 511), dtype=torch.bfloat16, seed=9)
    rows["mistral_wrapped"] = decode_case(
        "decode_mistral_wrapped_window512", B=1, W=1024, H=32, KV=8, D=128,
        t=1500, pos=ring_positions(1024, 1500), window=512,
        dtype=torch.bfloat16, seed=2)
    rows["all_invalid"] = decode_case(
        "decode_all_invalid_1x20x4x2x8", B=1, W=20, H=4, KV=2, D=8, t=3,
        pos=torch.full((20,), -1, dtype=torch.int32), seed=3)
    # the edges of the split over W (decode_attention.plan_splits: 16
    # chunks of 64 slots at Mistral's width): valid slots in the first
    # chunk only; none valid (the mean over every chunk); a window whose
    # valid slots lie inside one chunk of a wrapped ring; W = 20 and 37
    # (chunks of 2 and 3 slots, the last one short); B = 2 (8 chunks of
    # two 64-slot tiles); rows off 16-byte boundaries (staged element by
    # element)
    mistral = dict(W=1024, H=32, KV=8, D=128, dtype=torch.bfloat16)
    rows["mistral_t2"] = decode_case(
        "decode_mistral_t2", B=1, t=2, pos=ring_positions(1024, 2), seed=4,
        **mistral)
    rows["mistral_all_invalid"] = decode_case(
        "decode_mistral_all_invalid", B=1, t=2,
        pos=torch.full((1024,), -1, dtype=torch.int32), seed=5, **mistral)
    rows["mistral_window_one_chunk"] = decode_case(
        "decode_mistral_wrapped_window48", B=1, t=1535,
        pos=ring_positions(1024, 1535), window=48, seed=6, **mistral)
    for W in (20, 37):
        pos = ring_positions(W, W + 9)
        pos[::5] = -1
        rows[f"slots_{W}"] = decode_case(
            f"decode_1x{W}x32x8x128", B=1, W=W, H=32, KV=8, D=128, t=W + 9,
            pos=pos, seed=W)
    rows["mistral_b2"] = decode_case(
        "decode_mistral_b2", B=2, t=700, pos=ring_positions(1024, 700),
        seed=7, **mistral)
    rows["unaligned"] = decode_case(
        "decode_bf16_1x40x6x3x12_w30", B=1, W=40, H=6, KV=3, D=12, t=50,
        pos=ring_positions(40, 50), window=30, dtype=torch.bfloat16, seed=8)
    return rows


# ------------------------------------------------------------ rwkv_kernel

def rwkv_bound(B, S, H, n, *, s0, rkv_bytes=4):
    """Least time the card could take for one scan: r, k, v (``rkv_bytes``
    an element), w, u (and s0) read once, y and the final state written
    once, over HBM bandwidth; against the float32 operations per (step,
    batch, head) over the float32 rate: 5 n^2 (k v^T; w S + k v^T as a
    multiply and an add; r S as a multiply and an add) and 5 n for the
    bonus, which factors out as v_j (sum_i r_i u_i k_i)."""
    nbytes = (3 * rkv_bytes * B * S * H * n
              + 4 * (2 * B * S * H * n + H * n + (1 + s0) * B * H * n * n))
    ops = 5 * B * S * H * n * (n + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops, nbytes)


def rwkv_inputs(B, S, H, n, *, s0, seed, decay="range"):
    """r, k, v ~ N(0, 1); u ~ 0.1 N(0, 1); s0 ~ N(0, 1) or None; on the
    card. Decays w: "range" in (0.4, 0.9), tests/test_kernels.py's range;
    "model" as the model draws them, exp(-exp(w0 + lora)) with w0 spread
    over linspace(-6, -1) across the head dim and the lora term 0.5 N(0,
    1); "edges" the range with a tenth of the entries exactly 0 and a
    tenth exactly 1, which the model's double exp gives in float32."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, n), generator=g) for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, n), generator=g)) * 0.5 + 0.4
    if decay == "model":
        w = torch.exp(-torch.exp(torch.linspace(-6.0, -1.0, n)
                                 + 0.5 * torch.randn((B, S, H, n), generator=g)))
    elif decay == "edges":
        pick = torch.rand((B, S, H, n), generator=g)
        w = torch.where(pick < 0.1, 0.0, torch.where(pick > 0.9, 1.0, w))
    u = torch.randn((H, n), generator=g) * 0.1
    s = torch.randn((B, H, n, n), generator=g) if s0 else None
    return [x.cuda() if x is not None else None for x in (r, k, v, w, u, s)]


def rwkv_case(name, *, B, S, H, n, s0=False, seed=0, scaled=False,
              decay="range"):
    """Kernel vs plain version on the card at RWKV_TOL; with ``scaled``,
    RWKV_TOL of the output's own scale (max |plain|, at least 1): at full
    width the state sums hundreds of steps of N(0, 1) products. Every
    chunk length the kernel compiles is checked the same way and timed."""
    from repro_torch.kernels import rwkv6 as RW
    args = rwkv_inputs(B, S, H, n, s0=s0, seed=seed, decay=decay)
    before = RW.rwkv6_scan.launches
    y, sf = RW.rwkv6_scan(*args)
    torch.cuda.synchronize()
    check(RW.rwkv6_scan.launches == before + 1,
          f"{name}: launches {RW.rwkv6_scan.launches} != {before + 1}")
    yp, sp = RW.rwkv6_scan_plain(*args)
    check(bool(torch.isfinite(y).all() and torch.isfinite(sf).all()),
          f"{name}: non-finite output")
    err = max(float((y - yp).abs().max()), float((sf - sp).abs().max()))
    scale = max(1.0, float(yp.abs().max()), float(sp.abs().max()))
    tol = RWKV_TOL * (scale if scaled else 1.0)
    check(err <= tol, f"{name}: max |kernel - plain| = {err} > {tol}")
    by_chunk = {}
    for chunk in RW.CHUNKS:
        afn = lambda chunk=chunk: RW._launch(*args, chunk=chunk)  # noqa: E731
        ya, sa = afn()
        torch.cuda.synchronize()
        a_err = max(float((ya - yp).abs().max()), float((sa - sp).abs().max()))
        check(bool(torch.isfinite(ya).all() and torch.isfinite(sa).all())
              and a_err <= tol, f"{name}: chunk={chunk}: max |kernel - "
              f"plain| = {a_err} > {tol}")
        by_chunk[chunk] = {"max_abs_err": a_err, "ms": device_ms_cold(afn)}
    b_ms, b_by, ops, nbytes = rwkv_bound(B, S, H, n, s0=s0)
    kfn = lambda: RW.rwkv6_scan(*args)  # noqa: E731
    pfn = lambda: RW.rwkv6_scan_plain(*args)  # noqa: E731
    row = dict(name=name, shape=dict(B=B, S=S, H=H, n=n, s0=s0),
               decay=decay, plan=RW.plan_chunks(B, S, H, n),
               by_chunk=by_chunk,
               max_abs_err=err, scale=scale, tol=tol, ms=device_ms_cold(kfn),
               plain_ms=device_ms_cold(pfn, reps=5 if S > 100 else 25),
               library_ms=None, ms_l2_warm=device_ms(kfn),
               call_ms=call_ms(kfn), bound_ms=b_ms, bound_by=b_by, ops=ops,
               bytes=nbytes)
    emit("rwkv_kernel", **row)
    return row


def rwkv_half_case(name, *, B, S, H, n, seed, dtype=torch.bfloat16,
                   decay="range"):
    """r, k and v in ``dtype`` (w, u, s0 float32), as RWKV6-1.6B's bf16
    model passes them: every chunk length bit-equal to the float32 launch
    on the up-cast inputs, then the plain version within RWKV_TOL of the
    output's scale; timed beside the float32 launch and beside what the
    model ran before the scan took half types (three casts to float32,
    then the float32 launch)."""
    from repro_torch.kernels import rwkv6 as RW
    r, k, v, w, u, s0 = rwkv_inputs(B, S, H, n, s0=True, seed=seed,
                                    decay=decay)
    args = [x.to(dtype) for x in (r, k, v)] + [w, u, s0]
    up = [x.float() for x in args[:3]] + [w, u, s0]
    before = RW.rwkv6_scan.launches
    y, sf = RW.rwkv6_scan(*args)
    torch.cuda.synchronize()
    check(RW.rwkv6_scan.launches == before + 1,
          f"{name}: launches {RW.rwkv6_scan.launches} != {before + 1}")
    y32, s32 = RW._launch(*up)
    check(y.dtype == sf.dtype == torch.float32, f"{name}: outputs "
          f"{y.dtype}/{sf.dtype}, not float32")
    check(torch.equal(y, y32) and torch.equal(sf, s32),
          f"{name}: {dtype} scan differs from the float32 launch on the "
          "up-cast inputs")
    by_chunk = {}
    for chunk in RW.CHUNKS:
        afn = lambda chunk=chunk: RW._launch(*args, chunk=chunk)  # noqa: E731
        ya, sa = afn()
        yb, sb = RW._launch(*up, chunk=chunk)
        torch.cuda.synchronize()
        check(torch.equal(ya, yb) and torch.equal(sa, sb),
              f"{name}: chunk={chunk}: not bit-equal to the float32 launch")
        by_chunk[chunk] = {"bit_equal": True, "ms": device_ms_cold(afn)}
    yp, sp = RW.rwkv6_scan_plain(*args)
    err = max(float((y - yp).abs().max()), float((sf - sp).abs().max()))
    scale = max(1.0, float(yp.abs().max()), float(sp.abs().max()))
    check(err <= RWKV_TOL * scale, f"{name}: max |kernel - plain| = {err} "
          f"> {RWKV_TOL} x {scale}")
    b_ms, b_by, ops, nbytes = rwkv_bound(B, S, H, n, s0=True,
                                         rkv_bytes=args[0].element_size())
    kfn = lambda: RW.rwkv6_scan(*args)  # noqa: E731
    ffn = lambda: RW.rwkv6_scan(*up)  # noqa: E731
    cfn = lambda: RW.rwkv6_scan(args[0].float(), args[1].float(),  # noqa: E731
                                args[2].float(), w, u, s0)
    pfn = lambda: RW.rwkv6_scan_plain(*args)  # noqa: E731
    ms, f32_ms, cast_ms = device_ms_cold(kfn), device_ms_cold(ffn), \
        device_ms_cold(cfn)
    row = dict(name=name, shape=dict(B=B, S=S, H=H, n=n, s0=True),
               dtype=str(dtype).split(".")[-1], decay=decay,
               plan=RW.plan_chunks(B, S, H, n), by_chunk=by_chunk,
               bit_equal_to_float32=True, max_abs_err=err, scale=scale,
               tol=RWKV_TOL * scale, ms=ms, float32_ms=f32_ms,
               casts_then_float32_ms=cast_ms,
               plain_ms=device_ms_cold(pfn, reps=5 if S > 100 else 25),
               library_ms=None, ms_l2_warm=device_ms(kfn),
               call_ms=call_ms(kfn), bound_ms=b_ms, bound_by=b_by, ops=ops,
               bytes=nbytes)
    emit("rwkv_kernel", **row)
    return row


def phase_rwkv_kernel():
    from repro_torch.kernels import rwkv6 as RW
    rows = {}
    for B, S, H, n in ((2, 32, 2, 16), (1, 100, 4, 8), (2, 17, 1, 32),
                       (1, 64, 8, 64)):           # tests/test_kernels.py
        name = f"rwkv_{B}x{S}x{H}x{n}"
        rows[name] = rwkv_case(name, B=B, S=S, H=H, n=n, seed=S)
    # the chunked-prefill contract: two calls chained through the state
    # equal one call
    r, k, v, w, u, _ = rwkv_inputs(1, 48, 2, 16, s0=False, seed=48)
    y_full, s_full = RW.rwkv6_scan(r, k, v, w, u)
    y1, s1 = RW.rwkv6_scan(r[:, :24].contiguous(), k[:, :24].contiguous(),
                           v[:, :24].contiguous(), w[:, :24].contiguous(), u)
    y2, s2 = RW.rwkv6_scan(r[:, 24:].contiguous(), k[:, 24:].contiguous(),
                           v[:, 24:].contiguous(), w[:, 24:].contiguous(), u,
                           s1)
    chain_err = max(float((torch.cat([y1, y2], 1) - y_full).abs().max()),
                    float((s2 - s_full).abs().max()))
    check(chain_err <= RWKV_TOL, f"chained scan differs by {chain_err}")
    emit("rwkv_kernel", name="rwkv_chained_24+24", max_abs_err=chain_err)
    # RWKV6-1.6B: 32 heads of 64; a 520-token prefill (not a multiple of
    # 64) and one decode step, each from a nonzero state
    rows["prefill_520"] = rwkv_case("rwkv_prefill_1x520x32x64", B=1, S=520,
                                    H=32, n=64, s0=True, seed=1, scaled=True)
    rows["decode_1"] = rwkv_case("rwkv_decode_1x1x32x64", B=1, S=1, H=32,
                                 n=64, s0=True, seed=2, scaled=True)
    # the same two calls with decays as the model draws them, and a small
    # scan whose decays hold exact 0s and 1s (no NaN from a log of 0)
    rows["prefill_520_model"] = rwkv_case(
        "rwkv_prefill_1x520x32x64_model_decay", B=1, S=520, H=32, n=64,
        s0=True, seed=3, scaled=True, decay="model")
    rows["decode_1_model"] = rwkv_case(
        "rwkv_decode_1x1x32x64_model_decay", B=1, S=1, H=32, n=64, s0=True,
        seed=4, scaled=True, decay="model")
    rows["edges"] = rwkv_case("rwkv_1x40x2x16_exact_0_and_1", B=1, S=40,
                              H=2, n=16, s0=True, seed=5, decay="edges")
    # bf16 r/k/v as the bf16 model passes them: the 520-token prefill and
    # a decode step at RWKV6-1.6B's heads; fp16 and rows off 16 bytes
    # (n=20: element by element) on no served path
    rows["prefill_520_bf16"] = rwkv_half_case(
        "rwkv_prefill_1x520x32x64_bf16", B=1, S=520, H=32, n=64, seed=6,
        decay="model")
    rows["decode_1_bf16"] = rwkv_half_case(
        "rwkv_decode_1x1x32x64_bf16", B=1, S=1, H=32, n=64, seed=7,
        decay="model")
    rows["fp16_odd"] = rwkv_half_case(
        "rwkv_1x45x3x20_fp16", B=1, S=45, H=3, n=20, seed=8,
        dtype=torch.float16)
    return rows


# -------------------------------------------------------------------- llm

LLM_ARCHS = ("mistral-nemo-12b", "rwkv6-1.6b", "olmoe-1b-7b",
             "codeqwen1.5-7b", "nemotron-4-15b", "qwen1.5-32b")
LLM_LOGIT_TOL = 1e-4    # reduced float32 models, card vs CPU
# served at full width with the whole mix (eager server, profiler, kernel
# inputs captured); the other archs with the trimmed one (llm_dense)
LLM_FULL_MIX = ("mistral-nemo-12b", "rwkv6-1.6b", "olmoe-1b-7b")
# prefill(kernel="pallas") held against "jnp" at full width
LLM_PALLAS_PREFILL = ("mistral-nemo-12b", "olmoe-1b-7b")


def has_attention(cfg):
    return any(s.mixer == "attn" for specs, _ in cfg.groups for s in specs)


def want_launches(cfg, calls):
    """(decode_attention, rwkv6_scan) launches a server's calls imply:
    decode attention once a layer a decode step on an attention arch, the
    scan once a layer a prefill or a decode step on RWKV6."""
    L = cfg.n_layers
    if has_attention(cfg):
        return [L * calls["decode"], 0]
    return [0, L * (calls["prefill"] + calls["decode"])]


def llm_counters():
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import rwkv6 as RW
    return DA.decode_attention, RW.rwkv6_scan


def two_layers(cfg):
    import dataclasses
    return dataclasses.replace(cfg, groups=((cfg.groups[0][0], 2),),
                               n_layers=2)


class Recorder:
    """Wraps a server's prefill and decode steps: counts the calls,
    keeps each call's logits on the host (``keep``), and times each
    prefill, and each decode step while ``time_decode`` is set, with the
    card synchronised after it (otherwise decode steps queue without a
    sync, as the server runs them). ``_prefill`` returns (logits, cache),
    ``_decode`` the logits of a step over the server's static cache."""

    def __init__(self, srv, *, keep=False, timed=False):
        self.calls = {"prefill": 0, "decode": 0}
        self.logits, self.ms = [], {"prefill": [], "decode": []}
        self.finite = None
        self.time_decode = False
        for kind in ("prefill", "decode"):
            fn = getattr(srv, f"_{kind}")
            setattr(srv, f"_{kind}", self._wrap(kind, fn, keep, timed))

    def _wrap(self, kind, fn, keep, timed):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            logits = out[0] if kind == "prefill" else out
            if timed and (kind == "prefill" or self.time_decode):
                torch.cuda.synchronize()
                self.ms[kind].append((time.perf_counter() - t0) * 1e3)
            ok = torch.isfinite(logits).all()
            self.finite = ok if self.finite is None else self.finite & ok
            self.calls[kind] += 1
            if keep:
                self.logits.append(logits.float().cpu())
            return out
        return call


def llm_mix(srv, request_cls):
    """examples/llm_generate.py's mix: a 32-token system prompt, then 4
    users of +2 tokens, 8 new tokens each."""
    system = np.arange(1, 33, dtype=np.int32)
    out = [srv.serve_one(request_cls("warm", system, max_new_tokens=1))]
    for i in range(4):
        u = np.array([40 + i, 50 + i], np.int32)
        out.append(srv.serve_one(request_cls(
            f"u{i}", np.concatenate([system, u]), max_new_tokens=8)))
    return out


def llm_reduced(arch):
    """(i) the reduced 2-layer float32 model served on the card and on the
    CPU: the same tokens and stats, logits of every call within
    LLM_LOGIT_TOL; a prefix hit's tokens equal a cold server's; one
    decode graph on the card and one signature on the CPU; a second pass
    capturing nothing; an eager server's logits bit-equal."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import LLMServer, Request
    cfg = two_layers(reduced(get_config(arch)))
    cpu_params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    params = tree_to(cpu_params, "cuda")
    mem0 = torch.cuda.memory_reserved()
    for k in llm_counters():
        k.launches = 0
    srv = LLMServer(cfg, params, cache_len=96, device="cuda")
    step = count_runs(srv._decode_step)
    rec = Recorder(srv, keep=True)
    res = llm_mix(srv, Request)
    launches = [k.launches for k in llm_counters()]
    caps = captures([step])
    cpu = LLMServer(cfg, cpu_params, cache_len=96, device="cpu")
    cpu_rec = Recorder(cpu, keep=True)
    cpu_res = llm_mix(cpu, Request)
    check(srv.stats == cpu.stats, f"{arch}: stats {srv.stats} != CPU "
          f"{cpu.stats}")
    check(all(np.array_equal(a.tokens, b.tokens) for a, b in zip(res, cpu_res)),
          f"{arch}: card and CPU tokens differ")
    check(len(rec.logits) == len(cpu_rec.logits), f"{arch}: call counts differ")
    diff = max(float((a - b).abs().max())
               for a, b in zip(rec.logits, cpu_rec.logits))
    check(diff <= LLM_LOGIT_TOL, f"{arch}: card vs CPU logits {diff} > "
          f"{LLM_LOGIT_TOL}")
    cold = LLMServer(cfg, params, cache_len=96, device="cuda",
                     enable_prefix_cache=False)
    cold_res = llm_mix(cold, Request)
    check(all(a.prefix_hit and np.array_equal(a.tokens, b.tokens)
              for a, b in zip(res[1:], cold_res[1:])),
          f"{arch}: prefix-hit tokens differ from a cold server's")
    want = want_launches(cfg, rec.calls)
    check(launches == want, f"{arch}: launches {launches} != {want}")
    # the eager server on the card: every call's logits bit for bit
    eager = LLMServer(cfg, params, cache_len=96, jit=False, device="cuda")
    eager_rec = Recorder(eager, keep=True)
    eager_res = llm_mix(eager, Request)
    check(all(np.array_equal(a.tokens, b.tokens)
              for a, b in zip(res, eager_res))
          and len(eager_rec.logits) == len(rec.logits)
          and all(torch.equal(a, b)
                  for a, b in zip(rec.logits, eager_rec.logits)),
          f"{arch}: graphed and eager decode differ on the card")
    # a second pass of the mix on the same server: replays only
    llm_mix(srv, Request)
    graphs = graph_row(srv.compile_count(), cpu.compile_count(), [step],
                       caps, mem0)
    return dict(arch=arch, stats=cpu.stats, calls=cpu_rec.calls,
                max_abs_logit_diff=diff, launches=launches,
                first_tokens=res[1].tokens.tolist(), graphs=graphs)


def llm_full(arch, cpu_count):
    """(ii) the full-width bf16 model on the card: a 512-token system
    prompt served once, 4 hits of it + 8 user tokens (16 new tokens each),
    one cold 520-token request; cache_len 1024. Checked and timed as the
    server runs it (decode steps queued with no sync: tokens/s); then one
    more hit with every decode step synchronised (per-token latency) and
    one under the profiler (the card's busy share), both replaying the
    one decode graph (``cpu_count``: the reduced CPU server's signature
    count). Then an eager server on the card (trimmed: the system prompt
    and its first hit): the same tokens, its per-token latency, and two
    of its kernel calls held against the plain version."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import LLMServer, Request
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(a.numel() for a in leaves(params))
    weight_bytes = sum(a.numel() * a.element_size()
                       for a in leaves(params))
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    system = rng.integers(1, V, 512).astype(np.int32)
    users = [rng.integers(1, V, 8).astype(np.int32) for _ in range(4)]
    cold_prompt = rng.integers(1, V, 520).astype(np.int32)
    L = cfg.n_layers
    name = "decode_attention" if has_attention(cfg) else "rwkv6_scan"

    srv = LLMServer(cfg, params, cache_len=1024, device="cuda")
    step = count_runs(srv._decode_step)
    rec = Recorder(srv, timed=True)
    mem0 = torch.cuda.memory_reserved()
    for k in llm_counters():
        k.launches = 0                          # the main path starts here
    t0 = time.perf_counter()
    res = [srv.serve_one(Request("system", system, max_new_tokens=1))]
    t1 = time.perf_counter()
    res += [srv.serve_one(Request(f"u{i}", np.concatenate([system, u]),
                                  max_new_tokens=16))
            for i, u in enumerate(users)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res.append(srv.serve_one(Request("cold", cold_prompt, max_new_tokens=16)))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = [k.launches for k in llm_counters()]  # ... and ends here
    caps = captures([step])
    peak = torch.cuda.max_memory_allocated()
    hits = sum(r.prefix_hit for r in res)
    check(hits == 4, f"{arch}: {hits}/4 prefix hits")
    want_stats = {"prefix_hits": 4, "prefix_misses": 2,
                  "prefill_tokens": 512 + 4 * 8 + 520,
                  "decode_steps": 4 * 15 + 15}
    check(srv.stats == want_stats, f"{arch}: stats {srv.stats} != "
          f"{want_stats}")
    want_calls = {"prefill": 2, "decode": 4 * (8 + 15) + 15}
    check(rec.calls == want_calls, f"{arch}: calls {rec.calls} != "
          f"{want_calls}")
    want = want_launches(cfg, want_calls)
    check(launches == want, f"{arch}: launches (decode_attention, rwkv6_scan)"
          f" {launches} != {want}")
    check(bool(rec.finite), f"{arch}: non-finite logits")
    check(all(len(r.tokens) in (1, 16) and 0 <= r.tokens.min()
              and r.tokens.max() < V for r in res), f"{arch}: bad tokens")

    stats, calls = dict(srv.stats), dict(rec.calls)
    # per-token latency: one more hit with each decode step synchronised
    rec.time_decode = True
    srv.serve_one(Request("latency", np.concatenate([system, users[1][::-1]]),
                          max_new_tokens=16))
    rec.time_decode = False
    # one more hit under the profiler: the card's busy share of its wall
    busy_us, kernel_share, prof_wall_us, top = device_time(
        lambda: srv.serve_one(Request("prof", np.concatenate(
            [system, users[0][::-1]]), max_new_tokens=16)),
        "decode_attention_kernel" if name == "decode_attention"
        else "rwkv6_")             # rwkv6_chunk_kernel and rwkv6_step_kernel
    graphs = graph_row(srv.compile_count(), cpu_count, [step], caps, mem0)
    dec = sorted(rec.ms["decode"])
    gen_tokens = sum(len(r.tokens) for r in res[1:])
    del srv
    gc.collect()
    pallas = (pallas_prefill(cfg, params, cold_prompt)
              if arch in LLM_PALLAS_PREFILL else None)
    upcast = (rwkv_upcast_prefill(cfg, params, cold_prompt)
              if name == "rwkv6_scan" else None)

    # the eager server, trimmed: the system prompt and its first hit (as
    # the server runs them), then one hit with each step synchronised.
    # Real kernel inputs of layer 3 are captured from it: its 1st call
    # (the system prompt's prefill for RWKV, the first decode step for
    # Mistral) and its call two steps later (a decode step either way)
    eager = LLMServer(cfg, params, cache_len=1024, jit=False, device="cuda")
    erec = Recorder(eager, timed=True)
    captured, ncalls = [], [0]
    orig = getattr(ops, name)

    def capture(*a, **kw):
        ncalls[0] += 1
        if ncalls[0] in (3, 2 * L + 3):
            captured.append(([x.clone() if isinstance(x, torch.Tensor) else x
                              for x in a], dict(kw)))
        return orig(*a, **kw)

    setattr(ops, name, capture)
    try:
        e_res = [eager.serve_one(Request("system", system, max_new_tokens=1))]
        te0 = time.perf_counter()
        e_res.append(eager.serve_one(Request(
            "u0", np.concatenate([system, users[0]]), max_new_tokens=16)))
        torch.cuda.synchronize()
        te1 = time.perf_counter()
    finally:
        setattr(ops, name, orig)
    check(all(np.array_equal(a.tokens, b.tokens)
              for a, b in zip(e_res, res[:2])),
          f"{arch}: eager tokens {[r.tokens.tolist() for r in e_res]} != "
          f"graphed {[r.tokens.tolist() for r in res[:2]]}")
    erec.time_decode = True
    eager.serve_one(Request("latency", np.concatenate(
        [system, users[1][::-1]]), max_new_tokens=16))
    edec = sorted(erec.ms["decode"])

    # the captured layer's inputs: kernel vs plain version
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import rwkv6 as RW
    check(len(captured) == 2, f"{arch}: captured {len(captured)} calls")
    cap = []
    for a, kw in captured:
        if name == "decode_attention":
            got = DA.decode_attention(*a, **kw)
            plain = DA.decode_attention_plain(*a, **kw)
            steps = bf16_steps(got, plain)
            cap.append(dict(q=list(a[0].shape), cache=list(a[1].shape),
                            t=int(a[4]), max_bf16_steps=steps))
            check(steps <= 1.0, f"{arch}: captured decode attention {steps}"
                  " bf16 steps from plain")
        else:
            (y, s), (yp, sp) = RW.rwkv6_scan(*a), RW.rwkv6_scan_plain(*a)
            err = max(float((y - yp).abs().max()),
                      float((s - sp).abs().max()))
            scale = max(1.0, float(yp.abs().max()), float(sp.abs().max()))
            # the model passes r/k/v in its bf16: the same scan as the
            # float32 launch on them up-cast, bit for bit
            y32, s32 = RW.rwkv6_scan(*(x.float() for x in a[:3]), *a[3:])
            bit_equal = bool(torch.equal(y, y32) and torch.equal(s, s32))
            cap.append(dict(r=list(a[0].shape), s0=a[5] is not None,
                            rkv_dtype=str(a[0].dtype).split(".")[-1],
                            max_abs_err=err, scale=scale,
                            bit_equal_to_float32=bit_equal))
            check(a[0].dtype == getattr(torch, cfg.dtype), f"{arch}: the "
                  f"scan took r in {a[0].dtype}, not the model's {cfg.dtype}")
            check(bit_equal, f"{arch}: captured bf16 scan differs from the "
                  "float32 launch on the up-cast inputs")
            check(err <= RWKV_TOL * scale, f"{arch}: captured scan {err} > "
                  f"{RWKV_TOL} x {scale}")

    row = dict(arch=arch, dtype=cfg.dtype, layers=L, params=n_params,
               weight_bytes=weight_bytes, init_s=init_s, stats=stats,
               calls=calls, launches=launches, captured=cap,
               prefill_ms=rec.ms["prefill"],
               decode_ms_p50=float(np.percentile(dec, 50)),
               decode_ms_p99=float(np.percentile(dec, 99)),
               weight_read_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
               active_weight_read_bound_ms=(cfg.active_param_count() * 2
                                            / HBM_BYTES_PER_S * 1e3),
               prefill_pallas=pallas, scan_upcast=upcast,
               system_wall_s=t1 - t0, hits_wall_s=t2 - t1,
               cold_wall_s=t3 - t2,
               tokens_per_s=gen_tokens / (t3 - t1),
               hit_tokens_per_s=4 * 16 / (t2 - t1),
               eager=dict(decode_ms_p50=float(np.percentile(edec, 50)),
                          decode_ms_p99=float(np.percentile(edec, 99)),
                          hit_tokens_per_s=16 / (te1 - te0),
                          prefill_ms=erec.ms["prefill"]),
               graphs=graphs,
               max_memory_allocated=peak, gpu_busy_us=busy_us,
               kernel_share_of_gpu_time=kernel_share,
               top_device_shares=top,
               profiled_wall_us=prof_wall_us,
               gpu_busy_share_of_profiled_wall=(busy_us / prof_wall_us
                                                if busy_us else None),
               first_tokens=res[1].tokens[:8].tolist())
    emit("llm_full", **row)
    del eager, params, res, e_res
    gc.collect()
    torch.cuda.empty_cache()
    return row


def leaves(tree):
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# prefill(kernel="pallas") against "jnp", end to end: bf16 steps of the
# logits' scale. Each layer's flash output is held to one step of the
# plain version's on that layer's own inputs; the two paths' logits then
# drift apart through the layers as any two roundings do (measured on
# the H100: 2.75 steps over Mistral-NeMo's 40 layers, 1.0 over OLMoE's
# 16). The row reports, beside it, how far serving the same prompt as a
# prefix hit instead of a cold prefill moves the logits.
PALLAS_PREFILL_STEPS = 4


def pallas_prefill(cfg, params, prompt, *, reps=3):
    """prefill(kernel="pallas") against kernel="jnp" on one prompt at full
    width in bf16: the flash kernel launched once a layer (the counter set
    to 0 just before this drive and read just after), every layer's
    kernel output within one bf16 step of its scale from the plain
    version on the same inputs, the last token's logits within
    PALLAS_PREFILL_STEPS bf16 steps of their scale and the same greedy
    token wherever the top two plain logits lie further apart than twice
    that; then each prefill timed ``reps`` more times in turns (jnp,
    pallas, pallas, jnp, ...), the card synchronised after each."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    tokens = torch.as_tensor(prompt[None], device="cuda")

    def run(kernel):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = T.prefill(params, cfg, tokens, cache_len=1024,
                              kernel=kernel)
        torch.cuda.synchronize()
        return logits, (time.perf_counter() - t0) * 1e3

    layer_steps = []
    orig = ops.flash_attention

    def held(q, k, v, **kw):                   # the layer's inputs, as called
        out = orig(q, k, v, **kw)
        plain = FA.flash_attention_plain(q, k, v, **kw)
        layer_steps.append(float((out.float() - plain.float()).abs().max())
                           / step_of_scale(plain))
        return out

    ops.flash_attention = held
    try:
        FA.flash_attention.launches = 0         # the drive starts here
        got, first_ms = run("pallas")
        launches = FA.flash_attention.launches  # ... and ends here
    finally:
        ops.flash_attention = orig
    want, first_plain_ms = run("jnp")
    check(launches == cfg.n_layers == len(layer_steps),
          f"{cfg.name}: prefill(kernel='pallas') launched flash {launches} "
          f"times, not {cfg.n_layers}")
    check(max(layer_steps) <= 1.0, f"{cfg.name}: a layer's flash output is "
          f"{max(layer_steps)} bf16 steps from plain")
    step = step_of_scale(want)
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()), f"{cfg.name}: non-finite logits")
    check(err <= PALLAS_PREFILL_STEPS * step, f"{cfg.name}: pallas vs jnp "
          f"prefill logits {err} > {PALLAS_PREFILL_STEPS} x {step}")
    top2 = want.float().topk(2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).min())
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    check(same or gap <= 2 * PALLAS_PREFILL_STEPS * step,
          f"{cfg.name}: pallas and jnp prefills pick different tokens "
          f"{gap} apart")
    # the yardstick beside it: the same prompt served as a prefix hit
    # (prefill of all but its last 8 tokens, then 8 decode steps)
    _, cache = T.prefill(params, cfg, tokens[:, :-8], cache_len=1024)
    for i in range(tokens.shape[1] - 8, tokens.shape[1]):
        hit, cache = T.decode_step(params, cfg, tokens[:, i:i + 1], cache, i)
    del cache
    hit_err = float((hit.float() - want.float()).abs().max())
    ms = {"pallas": [], "jnp": []}
    for i in range(reps):
        for kernel in (("jnp", "pallas") if i % 2 == 0 else ("pallas", "jnp")):
            ms[kernel].append(run(kernel)[1])
    return dict(prompt=len(prompt), launches=launches,
                layer_bf16_steps_max=max(layer_steps),
                max_abs_logit_diff=err, logit_step=step,
                logit_bf16_steps=err / step, same_argmax=same, top2_gap=gap,
                hit_vs_cold_logit_bf16_steps=hit_err / step,
                hit_same_argmax=bool(torch.equal(hit.argmax(-1),
                                                 want.argmax(-1))),
                first_ms={"pallas": first_ms, "jnp": first_plain_ms},
                ms_p50={k: float(np.median(v)) for k, v in ms.items()},
                ms=ms)


UPCAST_DECODE_STEPS = 8


def rwkv_upcast_prefill(cfg, params, prompt, *, reps=3):
    """RWKV6 with r/k/v passed to the scan in the model's bf16 (as the
    model runs now) against the same model with them up-cast to float32
    before the scan (as it ran before the scan took half types): the
    prompt's prefill and UPCAST_DECODE_STEPS greedy decode steps, logits
    bit for bit and the same tokens, the scan launched once a layer a
    call either way (its counter set to 0 just before each drive and read
    just after); then each prefill timed ``reps`` more times in turns
    (upcast, bf16, bf16, upcast, ...), the card synchronised after each."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6 as RW
    from repro_torch.models import transformer as T
    tokens = torch.as_tensor(prompt[None], device="cuda")
    orig = ops.rwkv6_scan

    def upcast(r, k, v, w, u, s0=None):
        return orig(r.float(), k.float(), v.float(), w, u, s0)

    def run(up, *, decode=False):
        ops.rwkv6_scan = upcast if up else orig
        try:
            RW.rwkv6_scan.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = T.prefill(params, cfg, tokens, cache_len=1024)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            outs, toks = [logits], []
            pos = tokens.shape[1]
            for i in range(UPCAST_DECODE_STEPS if decode else 0):
                tok = outs[-1][:, -1].argmax(-1)[:, None]
                toks.append(int(tok[0, 0]))
                logits, cache = T.decode_step(params, cfg, tok, cache, pos + i)
                outs.append(logits)
            torch.cuda.synchronize()
            return outs, toks, ms, RW.rwkv6_scan.launches
        finally:
            ops.rwkv6_scan = orig

    got, got_toks, first_ms, launches = run(False, decode=True)
    want, want_toks, first_up_ms, up_launches = run(True, decode=True)
    calls = 1 + UPCAST_DECODE_STEPS
    check(launches == up_launches == cfg.n_layers * calls,
          f"{cfg.name}: scan launches {launches} / {up_launches} != "
          f"{cfg.n_layers} x {calls}")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    check(same and got_toks == want_toks, f"{cfg.name}: the bf16 scan's "
          f"logits or tokens {got_toks} differ from the up-cast path's "
          f"{want_toks}")
    ms = {"bf16": [], "upcast": []}
    for i in range(reps):
        for kind in (("upcast", "bf16") if i % 2 == 0 else ("bf16", "upcast")):
            ms[kind].append(run(kind == "upcast")[2])
    return dict(prompt=len(prompt), decode_steps=UPCAST_DECODE_STEPS,
                launches=launches, bit_equal=same, tokens=got_toks,
                first_ms={"bf16": first_ms, "upcast": first_up_ms},
                prefill_ms_p50={k: float(np.median(v)) for k, v in ms.items()},
                prefill_ms=ms)


def llm_dense(arch, cpu_count):
    """(iii) a dense config at full width in bf16 with the trimmed mix: the
    512-token system prompt, one hit of it + 8 tokens and the cold
    520-token request, 16 new tokens each, cache_len 1024, graphed, as the
    server runs them (tokens/s); then one more hit with each decode step
    synchronised (per-token latency). Checked as llm_full checks: stats,
    calls, launches, finite logits, tokens in range, the decode graph's
    plateau against the reduced CPU server's count. Every layer is kept
    (the row's ``depth_cut`` says so): the weights and the five caches
    the mix holds fit on the card."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import LLMServer, Request
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(a.numel() * a.element_size() for a in leaves(params))
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    system = rng.integers(1, V, 512).astype(np.int32)
    user = rng.integers(1, V, 8).astype(np.int32)
    cold_prompt = rng.integers(1, V, 520).astype(np.int32)

    srv = LLMServer(cfg, params, cache_len=1024, device="cuda")
    step = count_runs(srv._decode_step)
    rec = Recorder(srv, timed=True)
    mem0 = torch.cuda.memory_reserved()
    for k in llm_counters():
        k.launches = 0                          # the main path starts here
    t0 = time.perf_counter()
    res = [srv.serve_one(Request("system", system, max_new_tokens=1))]
    t1 = time.perf_counter()
    res.append(srv.serve_one(Request("u0", np.concatenate([system, user]),
                                     max_new_tokens=16)))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res.append(srv.serve_one(Request("cold", cold_prompt, max_new_tokens=16)))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = [k.launches for k in llm_counters()]  # ... and ends here
    caps = captures([step])
    want_stats = {"prefix_hits": 1, "prefix_misses": 2,
                  "prefill_tokens": 512 + 8 + 520, "decode_steps": 15 + 15}
    check(srv.stats == want_stats, f"{arch}: stats {srv.stats} != "
          f"{want_stats}")
    want_calls = {"prefill": 2, "decode": (8 + 15) + 15}
    check(rec.calls == want_calls, f"{arch}: calls {rec.calls} != "
          f"{want_calls}")
    want = want_launches(cfg, want_calls)
    check(launches == want, f"{arch}: launches (decode_attention, rwkv6_scan)"
          f" {launches} != {want}")
    check(bool(rec.finite), f"{arch}: non-finite logits")
    check(all(len(r.tokens) in (1, 16) and 0 <= r.tokens.min()
              and r.tokens.max() < V for r in res), f"{arch}: bad tokens")
    stats, calls = dict(srv.stats), dict(rec.calls)
    rec.time_decode = True
    srv.serve_one(Request("latency", np.concatenate([system, user[::-1]]),
                          max_new_tokens=16))
    rec.time_decode = False
    graphs = graph_row(srv.compile_count(), cpu_count, [step], caps, mem0)
    peak = torch.cuda.max_memory_allocated()
    dec = sorted(rec.ms["decode"])
    row = dict(arch=arch, dtype=cfg.dtype, layers=cfg.n_layers,
               depth_cut=None, params=cfg.param_count(),
               weight_bytes=weight_bytes, init_s=init_s, stats=stats,
               calls=calls, launches=launches, prefill_ms=rec.ms["prefill"],
               decode_ms_p50=float(np.percentile(dec, 50)),
               decode_ms_p99=float(np.percentile(dec, 99)),
               weight_read_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
               hit_tokens_per_s=16 / (t2 - t1),
               tokens_per_s=sum(len(r.tokens) for r in res[1:]) / (t3 - t1),
               system_wall_s=t1 - t0, max_memory_allocated=peak,
               total_memory=torch.cuda.get_device_properties(0).total_memory,
               graphs=graphs, first_tokens=res[1].tokens[:8].tolist())
    emit("llm_dense", **row)
    del srv, params, res
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_llm():
    """{arch: its full-width row} and, under "reduced", the reduced float32
    rows."""
    reduced_rows = {arch: llm_reduced(arch) for arch in LLM_ARCHS}
    emit("llm_reduced", **reduced_rows)
    rows = {arch: (llm_full if arch in LLM_FULL_MIX else llm_dense)(
        arch, reduced_rows[arch]["graphs"]["compile_count"])
        for arch in LLM_ARCHS}
    return {**rows, "reduced": reduced_rows}


# ----------------------------------------------------------------- train

TRAIN_TV = ("text", "vitals")
TRAIN_TVS = ("text", "vitals", "scene")
TRAIN_RTOL = 1e-4       # card vs CPU losses: float32, TF32 off
TRAIN_STEPS = 200       # the launcher's --steps and the directional claims'
PMI_STEPS = 100         # the launcher's max(steps // 2, 50)


def step_flops(cfg, p, B):
    """6 x parameters x tokens each meets, forward and backward: the text
    encoder's non-embedding weights (of the 2-modal model ``p``) at B x S
    tokens, the GRU's at B x T steps, the heads' at B rows (the attention
    scores' own products are left out, as the 6N rule leaves them)."""
    from repro_torch.training import tree as T
    count = lambda t: sum(x.numel() for x in T.leaves(t))
    n_text = count(p["text"]) - count(p["text"]["tok"]) \
        - count(p["text"]["pos"])
    return 6 * B * (cfg.max_text_len * n_text
                    + cfg.vitals_len * count(p["vitals"])
                    + count(p["heads"])), n_text


def timed_steps(cfg, params, loader, steps):
    """``steps`` training steps on the card, each synchronised: the host
    wall per step, and the parameters after them."""
    from repro_torch.training import emsnet_trainer as ET
    step, init = ET.make_train_step(cfg, TRAIN_TV)
    state = init(params)
    walls, losses = [], []
    for _ in range(steps):
        batch = next(loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return walls, losses, (step, state, params)


def train_profile(fn, n_steps):
    """torch.profiler over ``fn`` (``n_steps`` training steps): the card's
    busy microseconds, the profiled wall, the 6 largest device entries'
    shares of the busy time, the 8 largest host ops' self time as shares
    of the wall, and kernel launches a step (the runtime's launch calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, host, launches = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            dev[e.key[:80]] = dev.get(e.key[:80], 0.0) + t
        else:
            host[e.key[:60]] = e.self_cpu_time_total
            if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                         "cuLaunchKernel", "cuLaunchKernelEx"):
                launches += e.count
    busy = sum(dev.values())
    top = lambda d, total: dict(sorted(((k, t / total) for k, t in d.items()),
                                       key=lambda kv: -kv[1])[:8])
    return (busy or None, wall_us, top(dev, busy) if busy else {},
            top(host, wall_us), launches / n_steps)


def train_timing(cfg, params, loader, B, steps):
    """ms per step p50/p99 over the steps after the first 3, samples/s,
    the card's busy share of 3 profiled steps, where the host's time goes,
    the FLOP bound."""
    flops, n_text = step_flops(cfg, params, B)
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, (step, state, params) = timed_steps(cfg, params, loader,
                                                       steps)
    steady = _percentiles(walls[3:])
    peak = torch.cuda.max_memory_allocated()

    def three():
        nonlocal params, state
        for _ in range(3):
            params, state, _ = step(params, state, next(loader))
    busy_us, prof_wall_us, top, host_top, launches = train_profile(three, 3)
    return dict(batch=B, steps_timed=len(walls) - 3, step_ms=steady,
                first_steps_ms=[1e3 * w for w in walls[:3]],
                samples_per_s=B / (steady["p50"] / 1e3),
                busy_share_of_profiled_wall=(busy_us / prof_wall_us
                                             if busy_us else None),
                busy_share_of_step_wall=(busy_us / (3e3 * steady["p50"])
                                         if busy_us else None),
                top_device_shares=top, top_host_self_shares=host_top,
                kernel_launches_per_step=launches,
                non_embedding_text_params=n_text, step_flops=flops,
                flop_bound_ms=flops / FP32_FLOP_PER_S * 1e3,
                step_p50_over_bound=steady["p50"] / (flops / FP32_FLOP_PER_S
                                                    * 1e3),
                memory_allocated_before=mem0, max_memory_allocated=peak,
                training_peak_bytes=peak - mem0,
                nvidia_smi=CARD.get("nvidia_smi")), losses


def card_vs_cpu(cfg, loader_fn, steps):
    """The first ``steps`` steps from one initial model, drawn on the CPU
    from a seeded generator and copied to the card: the losses of both
    devices, their largest relative difference, and the parameters'
    largest absolute difference after the steps."""
    from repro_torch.models import emsnet as E
    from repro_torch.training import emsnet_trainer as ET
    from repro_torch.training import tree as T
    init = E.init_params(cfg, torch.Generator().manual_seed(0), TRAIN_TV,
                         device="cpu")
    on_card = T.tree_map(lambda t: t.to("cuda"), init)
    cpu_p, cpu_l = ET.train(cfg, loader_fn(), modalities=TRAIN_TV,
                            steps=steps, params=init)
    gpu_p, gpu_l = ET.train(cfg, loader_fn(), modalities=TRAIN_TV,
                            steps=steps, params=on_card)
    rel = max(abs(a - b) / abs(b) for a, b in zip(gpu_l, cpu_l))
    pdiff = max(float((a.cpu() - b).abs().max())
                for a, b in zip(T.leaves(gpu_p), T.leaves(cpu_p)))
    check(all(math.isfinite(x) for x in gpu_l), f"non-finite loss {gpu_l}")
    check(rel <= TRAIN_RTOL, f"{cfg.text_encoder}: card vs CPU losses differ "
          f"by {rel} (relative) > {TRAIN_RTOL}: {gpu_l} vs {cpu_l}")
    return {"steps": steps, "cuda": gpu_l, "cpu": cpu_l,
            "max_rel_diff": rel, "param_max_abs_diff": pdiff}


def phase_train():
    """EMSNet multitask training on the card at the launcher's widths, on
    data from the port's own generator: TinyBERT-GRU-FC (card against CPU;
    the reference's three directional claims; PMI's frozen encoders;
    a checkpoint evaluated and served through the flash kernel) and
    BERT-base (20 steps, card against CPU at B=8), each timed."""
    from repro_torch.configs.emsnet import config
    from repro_torch.core import ProfileTable, profile
    from repro_torch.data import synthetic_nemsis as D
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import build_models, sample_payloads
    from repro_torch.models import emsnet as E
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import emsnet_trainer as ET
    from repro_torch.training import losses as LS
    from repro_torch.training import tree as T
    import tempfile

    cfg = config(text_encoder="tinybert", vocab_size=2048)   # as launch.train
    check(cfg.use_flash_text, "the port's config serves through the kernel")
    t0 = time.perf_counter()
    d1 = D.generate(cfg, 8000, seed=0)
    tr1, _, te1 = D.splits(d1)
    d2 = D.generate(cfg, 600, seed=7, modal3=True)
    tr2, _, te2 = D.splits(d2)
    data_s = time.perf_counter() - t0
    loader = lambda ds, B, mods=TRAIN_TV: D.loader(ds, B, modalities=mods)

    # (1) card against CPU, 5 steps at B=64
    secs = {"data": data_s}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = now - mark[0]
        mark[0] = now
    parity = card_vs_cpu(cfg, lambda: loader(tr1, 64), 5)
    lap("card_vs_cpu")

    # (2) the directional claims; no training step may call the kernel
    FA.flash_attention.calls = FA.flash_attention.launches = 0
    p2, l2 = ET.train(cfg, loader(tr1, 64), modalities=TRAIN_TV,
                      steps=TRAIN_STEPS, device="cuda")
    m2 = ET.evaluate(p2, cfg, te1, TRAIN_TV)
    pv, _ = ET.train(cfg, loader(tr1, 64, ("vitals",)),
                     modalities=("vitals",), steps=TRAIN_STEPS,
                     device="cuda")
    mv = ET.evaluate(pv, cfg, te1, ("vitals",))
    p3, l3 = ET.pmi_finetune(cfg, p2, loader(tr2, 32, TRAIN_TVS),
                             steps=PMI_STEPS)
    m3 = ET.evaluate(p3, cfg, te2, TRAIN_TVS)
    p3s, _ = ET.train(cfg, loader(tr2, 32, TRAIN_TVS),
                      modalities=TRAIN_TVS, steps=PMI_STEPS, device="cuda")
    m3s = ET.evaluate(p3s, cfg, te2, TRAIN_TVS)
    torch.cuda.synchronize()
    lap("claims")
    train_launches = (FA.flash_attention.calls, FA.flash_attention.launches)
    check(train_launches == (0, 0), f"training called the flash kernel "
          f"{train_launches} (calls, launches); it has no backward")
    first, last = float(np.mean(l2[:10])), float(np.mean(l2[-10:]))
    check(last < 0.7 * first, f"loss {first} -> {last}: not under 0.7x")
    check(m2["protocol_top1"] > mv["protocol_top1"] + 0.15,
          f"text+vitals top-1 {m2['protocol_top1']} not above vitals-only "
          f"{mv['protocol_top1']} + 0.15")
    check(m3["protocol_top1"] >= m3s["protocol_top1"],
          f"PMI top-1 {m3['protocol_top1']} under scratch "
          f"{m3s['protocol_top1']}")
    frozen = {m: all(torch.equal(a, b) for a, b in
                     zip(T.leaves(p2[m]), T.leaves(p3[m]))) for m in TRAIN_TV}
    check(all(frozen.values()), f"PMI moved a frozen encoder: {frozen}")

    # (3) checkpoint, restore into a fresh template on the card
    splits, params = build_models(cfg, seed=1, device="cuda")
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "emsnet.npz")
        CKPT.save(path, {"m2": p2, "m3": p3},
                  metadata={"metrics2": m2, "metrics3": m3})
        ck_bytes = os.path.getsize(path)
        restored = CKPT.restore(path, {"m2": params["m2"], "m3": params["m3"]})
        meta = CKPT.metadata(path)
    check(meta["metrics3"] == m3, "checkpoint metadata changed")
    for name, trained in (("m2", p2), ("m3", p3)):
        for a, b in zip(T.leaves(restored[name]), T.leaves(trained)):
            check(a.device.type == "cuda" and torch.equal(a, b),
                  f"restored {name} differs from the trained weights")

    # (4) the 3-modal test split through the flash kernel against the
    # einsum evaluation, batches of 64. The data drops words inside a
    # sentence (PAD holes), which the kv_lengths mode (PAD suffix only)
    # cannot mask; the segment mode, the serving config with
    # flash_segments, masks any key set: it is the one held to the einsum
    # evaluation, the kv_lengths mode's distance is reported
    ein_cfg = ET.train_config(cfg)
    seg_cfg = dataclasses.replace(cfg, flash_segments=True)
    batches = [ET.to_device(te2.batch(np.arange(i, min(i + 64, len(te2))),
                                      TRAIN_TVS), "cuda")
               for i in range(0, len(te2), 64)]
    with torch.inference_mode():
        kv_diff = max(float((E.forward(restored["m3"], cfg, b, TRAIN_TVS)[
            "protocol_logits"] - E.forward(restored["m3"], ein_cfg, b,
                                           TRAIN_TVS)["protocol_logits"])
            .abs().max()) for b in batches)
    holes = int(sum(((b["text"][:, 1:] > 0) & (b["text"][:, :-1] == 0))
                    .any(-1).sum() for b in batches))
    FA.flash_attention.launches = 0
    max_diff, top1_rows, top1_same, n_batches, hits = 0.0, 0, 0, 0, 0
    with torch.inference_mode():
        for batch in batches:
            fl = E.forward(restored["m3"], seg_cfg, batch, TRAIN_TVS)
            ei = E.forward(restored["m3"], ein_cfg, batch, TRAIN_TVS)
            n_batches += 1
            for k in fl:
                max_diff = max(max_diff, float((fl[k] - ei[k]).abs().max()))
            top2 = ei["protocol_logits"].topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 1e-3
            same = (fl["protocol_logits"].argmax(-1)
                    == ei["protocol_logits"].argmax(-1))
            top1_rows += int(clear.sum())
            top1_same += int((same & clear).sum())
            hits += float(LS.topk_accuracy(
                fl["protocol_logits"], batch["labels"]["protocol"],
                ks=(1,))["top1"]) * len(batch["text"])
    eval_launches = FA.flash_attention.launches
    n_layers = cfg.text_dims[0]
    check(eval_launches == n_layers * n_batches, f"evaluation launched the "
          f"kernel {eval_launches} times, expected {n_layers} x {n_batches}")
    check(max_diff <= TOL, f"flash vs einsum evaluation differ by {max_diff}")
    check(top1_same == top1_rows, f"top-1 differs on {top1_rows - top1_same} "
          f"of {top1_rows} rows with a clear margin")

    # (5) Table-6 episode 1 served per event with the restored m2/m3
    params.update(restored)
    payloads = sample_payloads(cfg)
    table = ProfileTable(base=profile(splits["m3"], params["m3"], payloads,
                                      device="cuda"))
    splits = fresh(splits)
    FA.flash_attention.launches = 0
    run = run_episodes(splits, params, payloads, table, "cuda",
                       episodes=(1,))[0]
    serve_launches = FA.flash_attention.launches
    text_models = sum("text" in sm.modalities() for sm in splits.values())
    text_events = sum(r.modality == "text" for r in run["engine"].records)
    check(serve_launches == n_layers * text_models * text_events,
          f"serving the trained weights launched the kernel {serve_launches} "
          f"times, expected {n_layers} x {text_models} x {text_events}")
    recs = [r.recommendation for r in run["engine"].records
            if r.recommendation is not None]
    check(recs and all(bool(torch.isfinite(t).all()) for rec in recs
                       for t in rec.values()),
          "a served recommendation of the trained model is not finite")

    lap("checkpoint_eval_serve")
    # (6) timing at TinyBERT width, B=64
    del splits, params, restored, p2, pv, p3, p3s
    torch.cuda.empty_cache()
    init = T.tree_map(lambda t: t.to("cuda"), E.init_params(
        cfg, torch.Generator().manual_seed(0), TRAIN_TV, device="cpu"))
    tiny_t, _ = train_timing(cfg, init, loader(tr1, 64), 64, 23)
    lap("timing")
    del init
    emit("train_tinybert", config="tinybert-gru-fc vocab 2048",
         seconds=secs, card_vs_cpu=parity,
         loss_first10=first, loss_last10=last,
         protocol_top1={"text+vitals": m2["protocol_top1"],
                        "vitals": mv["protocol_top1"],
                        "pmi": m3["protocol_top1"],
                        "scratch3": m3s["protocol_top1"]},
         metrics2=m2, metrics3=m3, pmi_loss_last10=float(np.mean(l3[-10:])),
         frozen_bit_identical=frozen, train_flash=train_launches,
         checkpoint_bytes=ck_bytes,
         flash_eval=dict(launches=eval_launches, batches=n_batches,
                         max_abs_diff=max_diff, clear_rows=top1_rows,
                         top1_same=top1_same, protocol_top1=hits / len(te2),
                         rows_with_pad_holes=holes,
                         kv_lengths_max_abs_diff=kv_diff),
         serve=dict(launches=serve_launches, recommendations=len(recs),
                    event_ms=_percentiles(run["event_s"])),
         timing=tiny_t)

    # (7) BERT-base: card against CPU at B=8, then 20 steps at B=64
    bcfg = config(text_encoder="bertbase", vocab_size=2048)
    mark[0] = time.perf_counter()
    secs = {}
    bparity = card_vs_cpu(bcfg, lambda: loader(tr1, 8), 2)
    lap("card_vs_cpu")
    torch.cuda.empty_cache()
    binit = T.tree_map(lambda t: t.to("cuda"), E.init_params(
        bcfg, torch.Generator().manual_seed(0), TRAIN_TV, device="cpu"))
    n_params = sum(t.numel() for t in T.leaves(binit))
    FA.flash_attention.calls = 0
    big_t, bl = train_timing(bcfg, binit, loader(tr1, 64), 64, 20)
    lap("steps")
    check(FA.flash_attention.calls == 0, "BERT-base training called flash")
    check(all(math.isfinite(x) for x in bl), f"BERT-base loss not finite {bl}")
    check(np.mean(bl[-5:]) < bl[0], f"BERT-base loss did not fall below the "
          f"first step's: {bl}")
    emit("train_bertbase", config="bertbase-gru-fc vocab 2048", seconds=secs,
         params=n_params, card_vs_cpu=bparity, losses=bl, timing=big_t)
    del binit
    torch.cuda.empty_cache()
    return {"train": train_launches[1], "eval": eval_launches,
            "serve": serve_launches}


# ----------------------------------------------------------------- fleet
#
# The region simulator (repro_torch.fleet) over engine replicas on the
# card. Drives (i) and (ii) run on a step clock (1 ms a time_fn() call),
# which makes the whole simulation a function of the code path, so the
# card's run is held to a CPU run field for field; (iii) runs on the real
# clock, each flush costing its measured wall (up to and including its
# torch.cuda.synchronize), by the method of benchmarks/fleet_load.py.

FLEET_PARITY_KW = dict(batch_bucket_min=2, max_coalesce=2)  # tests/test_fleet.py
FLEET_LOAD_KW = dict(batch_bucket_min=8, max_coalesce=8)    # fleet_load.py
FLEET_TIME_SCALE = 0.01      # fleet_load.py: incidents compressed 100x
FLEET_POINT_SESSIONS = 40    # fleet_load.py --smoke's sessions a point
FLEET_KNEE_FACTOR = 3.0      # fleet_load.py: the p99 blow-up past the knee
FLEET_EVENTS_PER_SESSION = 6  # 1 text + 3 vitals + 2 scene
SHED_GLASS = {"enc:text": 0.08, "enc:vitals": 0.01, "enc:scene": 0.05,
              "tail": 0.005, "full": 0.15}     # tests/test_fleet.py
LOAD_GLASS = {"enc:text": 0.08, "enc:vitals": 0.01, "enc:scene": 0.05,
              "tail": 0.02, "full": 0.16}      # fleet_load.py


class StepClock:
    """A ``time_fn`` that advances ``step`` seconds on every call."""

    def __init__(self, step=1e-3):
        self.n, self.step = 0, step

    def __call__(self):
        self.n += 1
        return self.n * self.step


def fleet_sim(splits, params, payloads, device, sessions, *, engine_kw,
              n_replicas=2, **kw):
    """A RegionSim over ``n_replicas`` engines on ``device``, run."""
    from repro_torch.fleet import RegionSim
    sim = RegionSim(splits, params, n_replicas=n_replicas,
                    engine_kw=dict(engine_kw), device=device, **kw)
    sim.run(sessions, lambda sid, ev: payloads[ev.modality])
    return sim


def compare_fleets(card, cpu, what):
    """Card vs CPU under the step clock: routes, shed sessions, flush log,
    TTFP and time-to-final, report and merged Prometheus text equal;
    glass records' times equal; finals and partials within TOL. Returns
    the largest |diff| of an output."""
    check(card.route_of == cpu.route_of and card.degraded == cpu.degraded,
          f"{what}: routes differ")
    check(card.flush_log == cpu.flush_log, f"{what}: flush logs differ")
    check(card.ttfp == cpu.ttfp and card.ttfinal == cpu.ttfinal,
          f"{what}: TTFP or time-to-final differ")
    check(card.report() == cpu.report(), f"{what}: reports differ")
    check(card.fleet_metrics().to_prometheus()
          == cpu.fleet_metrics().to_prometheus(),
          f"{what}: merged Prometheus text differs")
    diff = 0.0
    for sid in card.route_of:
        a, b = card.final_outputs(sid), cpu.final_outputs(sid)
        check(a is not None and b is not None and set(a) == set(b),
              f"{what}: {sid} has no final on one side")
        for k in a:
            check(bool(torch.isfinite(a[k]).all()), f"{what}: non-finite")
            diff = max(diff, float((a[k].cpu() - b[k]).abs().max()))
    recs = card.glass.records if card.glass is not None else []
    cpu_recs = cpu.glass.records if cpu.glass is not None else []
    check(len(recs) == len(cpu_recs), f"{what}: glass record counts differ")
    for a, b in zip(recs, cpu_recs):
        check((a.sid, a.index, a.model, a.t_arrival, a.t_emit, a.kind,
               a.degraded) == (b.sid, b.index, b.model, b.t_arrival,
                               b.t_emit, b.kind, b.degraded),
              f"{what}: glass record {a.sid}/{a.index} differs")
        check((a.outputs is None) == (b.outputs is None),
              f"{what}: glass output presence differs")
        for k in a.outputs or {}:
            diff = max(diff, float((a.outputs[k].cpu() - b.outputs[k])
                                   .abs().max()))
    check(diff <= TOL, f"{what}: outputs differ by {diff} > {TOL}")
    return diff


def per_event_finals(splits, params, payloads, device, sessions):
    """Each session's last final from its own engine with the parity
    bucket, flushed after every event."""
    from repro_torch.serving.api import build_engine
    out = {}
    for s in sessions:
        eng = build_engine(splits, params, "batch+stream",
                           share_encoders=True, deadline_s=None,
                           device=device, **FLEET_PARITY_KW)
        preds = []
        for ev in s.events:
            eng.submit(s.sid, ev, payloads[ev.modality])
            preds += eng.flush().predictions
        out[s.sid] = next(p.outputs for p in reversed(preds)
                          if p.kind == "final")
    return out


def _ttfp_ms(sim):
    xs = [1e3 * t for t in sim.ttfp.values()]
    if not xs:
        return {"n": 0}
    return {"n": len(xs), **{f"p{q}": float(np.percentile(xs, q))
                             for q in (50, 95, 99)}}


class FleetLoad:
    """benchmarks/fleet_load.py's method on one set of pieces: open-loop
    Poisson sessions compressed by FLEET_TIME_SCALE, the 8-row bucket,
    offered sessions held near FLEET_POINT_SESSIONS a point."""

    def __init__(self, splits, params, payloads, device):
        self.splits, self.params = splits, params
        self.payloads, self.device = payloads, device
        self.fns = graphed_pieces(splits)

    def run(self, *, rate, n_sessions, n_replicas, seed, admission=None,
            profile=None):
        from repro_torch.fleet import generate_workload
        sessions = generate_workload(rate, n_sessions / rate, seed=seed,
                                     time_scale=FLEET_TIME_SCALE)
        return fleet_sim(self.splits, self.params, self.payloads,
                         self.device, sessions, engine_kw=FLEET_LOAD_KW,
                         n_replicas=n_replicas,
                         admission=admission() if admission else None,
                         profile=profile)

    def point(self, **kw):
        """Warm, then measure: the first pass captures every signature the
        drive meets; the second replays the identical workload and is the
        one reported (its captures counted, expected 0)."""
        self.run(**kw)
        before = captures(self.fns)[0]
        t0 = time.perf_counter()
        sim = self.run(**kw)
        host_s = time.perf_counter() - t0
        rep = sim.report()
        check(rep["sessions_offered"]
              == rep["sessions_admitted"] + rep["sessions_shed"],
              f"fleet load {kw}: offered != admitted + shed")
        check(sim.glass is None or all(r.kind == "partial" and r.degraded
                                       for r in sim.glass.records),
              f"fleet load {kw}: a shed session got more than a partial")
        events = sum(n for *_, n in sim.flush_log)
        return sim, {
            "offered_sessions_per_s": kw["rate"],
            "replicas": kw["n_replicas"],
            "sessions": rep["sessions_offered"],
            "shed": rep["sessions_shed"],
            "degraded_partials": rep["degraded_partials"],
            "ttfp_ms": _ttfp_ms(sim),
            "finalized_sessions_per_s": (rep["sessions_finalized"]
                                         / rep["makespan_s"]),
            "events_per_flush": events / max(1, len(sim.flush_log)),
            "flushes": len(sim.flush_log),
            "residual_drain_s": rep["makespan_s"] - sim._last_arrival,
            "captures": captures(self.fns)[0] - before,
            "host_s": host_s}

    def service_rate(self, rate, seed=0):
        """Admitted events over summed flush walls on one replica, and
        the median flush wall (ms) by events in the flush."""
        sim = self.run(rate=rate, n_sessions=FLEET_POINT_SESSIONS,
                       n_replicas=1, seed=seed)
        busy = sum(done - start for _, start, done, _ in sim.flush_log)
        by_events = {}
        for _, start, done, n in sim.flush_log:
            by_events.setdefault(n, []).append(1e3 * (done - start))
        return (sum(n for *_, n in sim.flush_log) / busy,
                {n: {"flushes": len(w), "p50_ms": statistics.median(w)}
                 for n, w in sorted(by_events.items())})

    def sweep(self):
        """Calibration, the load curve over two replicas, shed-vs-queue at
        2x the knee, weak scaling over 1, 2 and 4 replicas."""
        from repro_torch.core import ProfileTable
        from repro_torch.fleet import AdmissionController, AdmissionPolicy
        n = FLEET_POINT_SESSIONS
        # warm-up as the reference benchmark does: spaced arrivals
        # (single-event flushes) and a burst (coalesced batches)
        self.run(rate=2.0, n_sessions=6, n_replicas=1, seed=0)
        self.run(rate=200.0, n_sessions=n, n_replicas=1, seed=0)
        (mu_light, light_walls), (mu_sat, sat_walls) = (
            self.service_rate(4.0), self.service_rate(200.0))
        cap_light = mu_light / FLEET_EVENTS_PER_SESSION
        cap = mu_sat / FLEET_EVENTS_PER_SESSION
        curve = []
        for frac in (0.25, 0.5, 1.0, 2.0):
            kw = dict(rate=frac * cap * 2,
                      n_sessions=int(round(n * max(1.0, frac))),
                      n_replicas=2, seed=1)
            curve.append({"x_capacity": frac, "kw": kw,
                          **self.point(**kw)[1]})
        base_p99 = min(c["ttfp_ms"]["p99"] for c in curve)
        knee = [c for c in curve
                if c["ttfp_ms"]["p99"] <= FLEET_KNEE_FACTOR * base_p99][-1]
        over = dict(rate=2.0 * knee["offered_sessions_per_s"],
                    n_sessions=2 * n, n_replicas=2, seed=2)
        _, queue = self.point(**over)
        deadline = knee["ttfp_ms"]["p99"] / 1e3
        _, shed = self.point(
            **over, profile=ProfileTable(base=dict(LOAD_GLASS)),
            admission=lambda: AdmissionController(AdmissionPolicy(
                deadline_s=deadline, enter_frac=1.0, exit_frac=0.5), 2))
        scaling = [self.point(rate=0.7 * cap_light * r, n_sessions=2 * n,
                              n_replicas=r, seed=3)[1] for r in (1, 2, 4)]
        return {"calibration": {
                    "service_rate_light_events_per_s": mu_light,
                    "service_rate_saturated_events_per_s": mu_sat,
                    "capacity_light_sessions_per_s": cap_light,
                    "capacity_saturated_sessions_per_s": cap,
                    "flush_wall_by_events": {"light": light_walls,
                                             "saturated": sat_walls}},
                "curve": curve,
                "knee": {"x_capacity": knee["x_capacity"],
                         "offered_sessions_per_s":
                             knee["offered_sessions_per_s"],
                         "p99_ms": knee["ttfp_ms"]["p99"],
                         "host_s": knee["host_s"], "kw": knee["kw"]},
                "shed_vs_queue": {"deadline_ms": 1e3 * deadline,
                                  "queue": queue, "shed": shed},
                "scaling": scaling}


def phase_fleet():
    """The region simulator at the launcher's TinyBERT-GRU-FC width over
    the 7-model zoo (one shared dict drawn on the CPU), on the card and on
    the CPU: (i) two replicas admitting every session of
    generate_workload(8, 2, seed=0, time_scale=0.2) under the parity
    bucket and a step clock of 1 ms a read; (i') the same drive at 50 ms a
    read against an 80 ms admission deadline (coalesced flushes, router
    spills, part of the load shed); (ii) the same drive shedding every
    session to the glass path (deadline 1e-4 s), streamed through a
    StreamingTracer; (iii) the load sweep on the real clock."""
    from repro_torch.configs.emsnet import config
    from repro_torch.core import ProfileTable
    from repro_torch.fleet import (AdmissionController, AdmissionPolicy,
                                   fleet_mesh, generate_workload,
                                   place_fleet_params)
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import build_zoo, sample_payloads
    from repro_torch.obs import StreamingTracer, audit_file

    cfg = config(text_encoder="tinybert", vocab_size=2048)
    n_layers = cfg.text_dims[0]
    payloads = sample_payloads(cfg)
    cpu_splits, cpu_params = build_zoo(cfg, device="cpu")
    splits = fresh(cpu_splits)
    text = counted_encoders(splits, "text")
    cpu_text = counted_encoders(cpu_splits, "text")
    mesh = fleet_mesh(device="cuda")
    params, placement = place_fleet_params(cpu_params, mesh)
    check((placement["param_leaves"], placement["sharded_leaves"],
           placement["replicated_leaves"]) == (63, 6, 57)
          and len({id(v) for v in params.values()}) == 1
          and next(iter(params.values()))["heads"]["protocol"]["w"].is_cuda,
          f"fleet placement {placement}")
    sessions = generate_workload(8, 2, seed=0, time_scale=0.2)
    n_events = sum(len(s.events) for s in sessions)

    def drive(what, *, step=1e-3, deadline=None, tracer=None):
        """The same drive on the card and on the CPU (each with its own
        clock and, with ``deadline``, its own admission controller and the
        glass profile), counters at 0 before each; checks them against
        each other and the flash launches against the CPU's calls and the
        text encodes."""
        sims, counts = [], []
        for device, sp, pp, tr in (("cuda", splits, params, tracer),
                                   ("cpu", cpu_splits, cpu_params, None)):
            kw = {} if deadline is None else dict(
                profile=ProfileTable(base=dict(SHED_GLASS)),
                admission=AdmissionController(AdmissionPolicy(
                    deadline_s=deadline), 2))
            text[0] = cpu_text[0] = 0
            reset_counts()                  # the path starts here
            t0 = time.perf_counter()
            sims.append(fleet_sim(sp, pp, payloads, device, sessions,
                                  engine_kw=dict(FLEET_PARITY_KW,
                                                 time_fn=StepClock(step)),
                                  tracer=tr, **kw))
            counts.append((FA.flash_attention.launches,
                           FA.flash_attention.calls, text[0] + cpu_text[0],
                           time.perf_counter() - t0))
        (launches, _, encodes, card_s), (_, calls, cpu_encodes, cpu_s) = counts
        check(launches == calls == n_layers * encodes > 0
              and encodes == cpu_encodes,
              f"fleet {what}: flash launches {launches} != the CPU run's "
              f"calls {calls} or {n_layers} x {encodes} text encodes")
        card, cpu = sims
        diff = compare_fleets(card, cpu, f"fleet {what} card vs cpu")
        check(card.admission.stats() == cpu.admission.stats()
              and card.admission.transitions == cpu.admission.transitions,
              f"fleet {what}: admission decisions differ")
        rep = card.report()
        check(rep["sessions_offered"] == len(sessions)
              == rep["sessions_admitted"] + rep["sessions_shed"]
              and (card.glass is None or all(
                  r.kind == "partial" and r.degraded
                  for r in card.glass.records)),
              f"fleet {what}: {rep}")
        return card, {"flushes": len(card.flush_log),
                      "max_events_per_flush": max(
                          [n for *_, n in card.flush_log], default=0),
                      "flash_launches": launches, "cpu_flash_calls": calls,
                      "max_abs_err_vs_cpu": diff, "report": rep,
                      "seconds": {"cuda": card_s, "cpu": cpu_s}}

    # (i) admit all, 1 ms a clock read; finals also against the card's
    # own per-event engine
    card, admit = drive("(i)")
    check(admit["report"]["sessions_finalized"] == len(sessions),
          f"fleet (i): {admit['report']}")
    ref = per_event_finals(splits, params, payloads, "cuda", sessions)
    diff_ref = 0.0
    for s in sessions:
        got = card.final_outputs(s.sid)
        for k in got:
            diff_ref = max(diff_ref, float((got[k] - ref[s.sid][k])
                                           .abs().max()))
    check(diff_ref <= TOL, f"fleet (i): finals {diff_ref} off the card's "
          "per-event engine")
    admit["finals_max_abs_err_vs_per_event"] = diff_ref
    # (i') 50 ms a clock read against an 80 ms deadline: flushes coalesce,
    # the router spills, part of the load sheds to the glass path
    mixed_sim, mixed = drive("(i')", step=5e-2, deadline=0.08)
    check(mixed_sim.router.spills > 0
          and mixed["max_events_per_flush"] > 1
          and 0 < mixed["report"]["sessions_shed"] < len(sessions),
          f"fleet (i'): no spill, coalescing or partial shed: "
          f"{mixed['report']}")
    # (ii) shed everything to the glass path, streamed to JSON Lines
    os.makedirs(OUT_DIR, exist_ok=True)
    jsonl = os.path.join(OUT_DIR, "fleet_shed.jsonl")
    tracer = StreamingTracer(jsonl, buffer=64)
    shed_sim, shed = drive("(ii)", tracer=tracer, deadline=1e-4)
    check(shed["report"]["sessions_shed"] == len(sessions)
          and len(shed_sim.glass.records) == n_events,
          f"fleet (ii): not every session shed: {shed['report']}")
    shed["trace_events"] = tracer.close(
        other_data={"metrics": shed_sim.fleet_metrics().snapshot()})
    audit = audit_file(jsonl)
    check(audit.ok, f"fleet (ii): the trace fails the audit: "
          f"{audit.violations[:3]}")
    shed["audit"] = audit.summary()

    # (iii) the load sweep on the real clock, graphed
    t3 = time.perf_counter()
    load = FleetLoad(splits, params, payloads, "cuda")
    sweep = load.sweep()
    check(all(row["captures"] == 0 for row in
              sweep["curve"] + sweep["scaling"]
              + [sweep["shed_vs_queue"]["queue"],
                 sweep["shed_vs_queue"]["shed"]]),
          "fleet (iii): a measured pass captured a graph")
    # the knee point once more under the profiler (card only): the busy
    # share against the profiled wall and against the measured pass's
    knee = sweep["knee"]
    busy_us, flash_share, wall_us, top = device_time(
        lambda: load.run(**knee["kw"]), "flash_fwd_kernel", host_ops=False)
    emit("fleet", card=CARD, placement=placement, sessions=len(sessions),
         events=n_events, admit_all=admit, mixed=mixed, shed_all=shed,
         load=sweep,
         profiled_knee_point={
             "busy_share_of_profiled_wall": (None if busy_us is None
                                             else busy_us / wall_us),
             "busy_share_of_measured_wall": (
                 None if busy_us is None
                 else busy_us / (1e6 * knee["host_s"])),
             "flash_share_of_busy": flash_share, "wall_ms": wall_us / 1e3,
             "top": top},
         seconds={"load": time.perf_counter() - t3})
    return (admit["flash_launches"] + mixed["flash_launches"]
            + shed["flash_launches"])


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
    # the robust command: speculation, re-dispatch, a chaos schedule, the
    # trace and the Prometheus page; then the auditor on the trace
    os.makedirs(OUT_DIR, exist_ok=True)
    trace = os.path.join(OUT_DIR, "robust_trace.json")
    prom = os.path.join(OUT_DIR, "robust.prom")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--engine", "tiered", "--tiers", "glass,ph1,edge64x",
              "--precision", "ph1=int8,edge64x=int8", "--speculate",
              "--redispatch", "--chaos-seed", "5", "--trace", trace,
              "--metrics-out", prom])
    robust = buf.getvalue().strip().splitlines()
    check(robust[0].startswith("fault schedule: chaos seed 5")
          and any(ln.startswith("speculation: ") for ln in robust)
          and any(ln.endswith("on cuda") for ln in robust)
          and robust[-1].startswith("trace: "),
          f"unexpected robust cli output {robust[:1] + robust[-3:]}")
    check("emsserve_serve_latency_s_count" in open(prom).read(),
          "robust cli wrote no latency summary")
    audit = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.audit", trace],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    check(audit.returncode == 0, f"the auditor exited {audit.returncode} on "
          f"the robust trace: {audit.stdout[-400:]}")
    # the flush path's commands: bucketed batch, ragged batch+stream with
    # grouped tails, and a stream replayed on the wall clock (the mix
    # scenario's ~9 s of episode time at 5x)
    flush_cli = {}
    for key, argv, head in (
            ("batch", ["--engine", "batch", "--sessions", "8"], "8 sessions"),
            ("batch_stream_ragged", ["--engine", "batch+stream", "--sessions",
                                     "8", "--ragged"], "ragged flush:"),
            ("stream_wall_clock", ["--engine", "stream", "--sessions", "4",
                                   "--wall-clock", "--deadline-ms", "50",
                                   "--speed", "5"], "4 sessions")):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main(argv)
        out = buf.getvalue().strip().splitlines()
        check(out[-1].startswith(head) and out[-1].endswith("on cuda"),
              f"unexpected {' '.join(argv)} output {out[-1:]}")
        graphs = [int(g) for ln in out
                  for g in re.findall(r"CUDA graphs (\d+)", ln)]
        check(len(graphs) == 1 and graphs[0] > 0,
              f"{' '.join(argv)} printed no CUDA graph count: {out[-2:]}")
        flush_cli[key] = {"lines": len(out), "last": out[-1],
                          "cuda_graphs": graphs[0],
                          "seconds": time.perf_counter() - t0}
    # the fleet: two replicas on the card, the trace streamed as JSON Lines
    # and audited, the merged metrics page; then a deprecated mode flag
    from repro_torch.obs import audit_file
    fleet_trace = os.path.join(OUT_DIR, "fleet_trace.jsonl")
    fleet_prom = os.path.join(OUT_DIR, "fleet.prom")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--fleet", "4", "--replicas", "2", "--sessions", "12",
              "--trace", fleet_trace, "--metrics-out", fleet_prom])
    fleet = buf.getvalue().strip().splitlines()
    check(fleet[0].startswith("fleet: 2 replicas")
          and any(ln.startswith("admitted TTFP") and ln.endswith("on cuda")
                  for ln in fleet) and fleet[-1].startswith("trace: "),
          f"unexpected fleet cli output {fleet[:1] + fleet[-3:]}")
    check("emsserve_fleet_ttfp_s_count" in open(fleet_prom).read(),
          "fleet cli wrote no TTFP summary")
    fleet_audit = audit_file(fleet_trace)
    check(fleet_audit.ok, f"the fleet trace fails the audit: "
          f"{fleet_audit.violations[:3]}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--batched", "8"])
    batched = buf.getvalue().strip().splitlines()
    check(batched[0] == "note: --batched N is deprecated — use `--engine "
          "batch --sessions 8` (specs compose, e.g. --engine stream+tiered)"
          and batched[-1].startswith("8 sessions")
          and batched[-1].endswith("on cuda"),
          f"unexpected --batched 8 output {batched[:1] + batched[-1:]}")
    # llm_generate with no --arch: one line per arch the registry serves
    from repro_torch.configs import ARCHS
    from repro_torch.launch.llm_generate import main as llm_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        llm_main([])
    llm = buf.getvalue().strip().splitlines()
    check(len(llm) == len(ARCHS) and all(
        ln.startswith(arch) for ln, arch in zip(llm, ARCHS)) and all(
        "4/4 prefix hits" in ln and ln.endswith("decode CUDA graphs 1 on cuda")
        for ln in llm), f"unexpected llm_generate output {llm}")
    # the training launcher at the full TinyBERT width, few steps
    import tempfile
    from repro_torch.launch.train import main as train_main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td, contextlib.redirect_stdout(buf):
        ckpt = os.path.join(td, "emsnet.npz")
        train_main(["--steps", "20", "--d1-size", "2000", "--out", ckpt])
        check(os.path.getsize(ckpt) > 0, "the train launcher wrote no file")
    train_out = buf.getvalue().strip().splitlines()
    check(train_out[0].endswith("on cuda")
          and any(ln.startswith("2-modal test") for ln in train_out)
          and any(ln.startswith("3-modal PMI test") for ln in train_out)
          and train_out[-1] == f"checkpoint -> {ckpt}",
          f"unexpected train launcher output {train_out[:1] + train_out[-2:]}")
    train_s = time.perf_counter() - t0
    emit("cli", lines=len(lines), last=lines[-1], tiered_lines=len(tiered),
         tiered_int8_records=sum("[int8]" in ln for ln in tiered),
         tiered_last=tiered[-1], robust=[ln for ln in robust
                                         if ln.startswith(("speculation",
                                                           "trace"))],
         robust_audit=audit.stdout.strip().splitlines()[-1],
         llm_generate=llm, flush_path=flush_cli,
         fleet=dict(lines=[ln for ln in fleet
                           if not ln.startswith("  replica ")],
                    audit=fleet_audit.summary()),
         batched=[batched[0], batched[-1]],
         train=dict(lines=train_out, seconds=train_s))


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


def _brief(row):
    return {k: row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")}


PHASES = {"kernel": phase_kernel, "int8": phase_int8,
          "decode_kernel": phase_decode_kernel,
          "rwkv_kernel": phase_rwkv_kernel, "serve": phase_serve,
          "bertbase": phase_bertbase, "tiered": phase_tiered,
          "robust": phase_robust, "batch": phase_batch,
          "fleet": phase_fleet, "train": phase_train,
          "llm": phase_llm, "cli": phase_cli}


def main():
    if sys.argv[1:]:
        # --only a,b: the device and build phases, then the named phases
        # alone; no summary and no result line (that needs every phase)
        if len(sys.argv) != 3 or sys.argv[1] != "--only" or \
                not set(sys.argv[2].split(",")) <= set(PHASES):
            raise SystemExit(f"usage: chip_smoke.py [--only PHASE[,PHASE]] "
                             f"with PHASE in {sorted(PHASES)}")
        phase_device()
        phase_build()
        for name in sys.argv[2].split(","):
            PHASES[name]()
        return
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    rows = timed("kernel", phase_kernel)
    int8_rows = timed("int8", phase_int8)
    decode_rows = timed("decode_kernel", phase_decode_kernel)
    rwkv_rows = timed("rwkv_kernel", phase_rwkv_kernel)
    serve_launches = timed("serve", phase_serve)
    bertbase_launches = timed("bertbase", phase_bertbase)
    tiered_launches = timed("tiered", phase_tiered)
    robust_launches = timed("robust", phase_robust)
    batch_launches = timed("batch", phase_batch)
    fleet_launches = timed("fleet", phase_fleet)
    train_launches = timed("train", phase_train)
    llm_rows = timed("llm", phase_llm)
    timed("cli", phase_cli)
    emit("done", seconds=time.perf_counter() - t0, phase_seconds=seconds)
    print(smi)
    kernels = [_line("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:98",
                     serve_launches, rows["per_event"],
                     launches_by_path={
                         "serve": serve_launches,
                         "tiered": tiered_launches["flash_attention"],
                         "robust": robust_launches["flash_attention"],
                         "bertbase": bertbase_launches, **batch_launches,
                         # the fleet's step-clock drives: two replicas
                         # (bucketed B=2) and the glass shed path (B=1)
                         "fleet": fleet_launches,
                         # the trained weights evaluated and served; a
                         # training step launches it 0 times
                         "train": train_launches["eval"]
                         + train_launches["serve"],
                         "train_steps": train_launches["train"],
                         # the LLM zoo's bf16 prefill through
                         # prefill(kernel="pallas"), one 520-token prompt
                         **{f"llm_prefill_pallas_{a}":
                            llm_rows[a]["prefill_pallas"]["launches"]
                            for a in LLM_PALLAS_PREFILL}}),
               _line("flash_attention_bertbase",
                     "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:98",
                     bertbase_launches, rows["bertbase_per_event"],
                     shape=rows["bertbase_per_event"]["shape"]),
               # the flush path: kv_lengths over bucketed batches, and the
               # segment mode over the packed ragged buffer
               _line("flash_attention_batch",
                     "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:98",
                     batch_launches["batch"] + batch_launches["batch_stream"],
                     rows["batch16_s64"], shape=rows["batch16_s64"]["shape"],
                     s32=_brief(rows["batch16_s32"])),
               _line("flash_attention_ragged",
                     "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:98",
                     batch_launches["ragged"]
                     + batch_launches["batch_stream_ragged"],
                     rows["ragged"], shape=rows["ragged"]["shape"]),
               # bf16 causal GQA: the LLM zoo's prefill(kernel="pallas")
               _line("flash_attention_prefill_bf16",
                     "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:98",
                     sum(llm_rows[a]["prefill_pallas"]["launches"]
                         for a in LLM_PALLAS_PREFILL),
                     rows["mistral_prefill_bf16"],
                     shape=rows["mistral_prefill_bf16"]["shape"],
                     dtype="bfloat16",
                     path=rows["mistral_prefill_bf16"]["path"],
                     plan=rows["mistral_prefill_bf16"]["plan"],
                     olmoe=_brief(rows["olmoe_prefill_bf16"]),
                     window128=_brief(rows["window_prefill_bf16"]),
                     olmoe_fp16=_brief(rows["olmoe_prefill_fp16"]))]
    for name, (source, replaces, row) in KERNELS.items():
        floor = ({"floor_ms": int8_rows["launch_floor"]["ms"]}
                 if name != "int8_matmul" else {})
        kernels.append(_line(name, source, replaces, tiered_launches[name],
                             int8_rows[row], shape=int8_rows[row]["shape"],
                             launches_by_path={
                                 "tiered": tiered_launches[name],
                                 "robust": robust_launches[name]},
                             **floor))
    # launches on the llm path: the full-width runs (decode attention on
    # every attention arch, the rwkv6 scan on RWKV6)
    mistral, rwkv = llm_rows["mistral-nemo-12b"], llm_rows["rwkv6-1.6b"]
    kernels.append(_line("decode_attention",
                         "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:68",
                         mistral["launches"][0], decode_rows["mistral_half"],
                         shape=decode_rows["mistral_half"]["shape"],
                         launches_by_path={
                             a: llm_rows[a]["launches"][0] for a in LLM_ARCHS
                             if llm_rows[a]["launches"][0]},
                         olmoe=_brief(decode_rows["olmoe_half"])))
    # the scan in float32 (the reduced float32 RWKV6 served on the card)
    # and with bf16 r/k/v (RWKV6-1.6B at full width in bf16)
    step_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    kernels.append(_line("rwkv6_scan", "src/repro_torch/csrc/rwkv6.cu",
                         "src/repro/kernels/rwkv6.py:62",
                         llm_rows["reduced"]["rwkv6-1.6b"]["launches"][1],
                         rwkv_rows["prefill_520"],
                         shape=rwkv_rows["prefill_520"]["shape"],
                         decode_step={k: rwkv_rows["decode_1"][k]
                                      for k in step_keys}))
    kernels.append(_line("rwkv6_scan_bf16", "src/repro_torch/csrc/rwkv6.cu",
                         "src/repro/kernels/rwkv6.py:62",
                         rwkv["launches"][1], rwkv_rows["prefill_520_bf16"],
                         shape=rwkv_rows["prefill_520_bf16"]["shape"],
                         dtype="bfloat16",
                         decode_step={k: rwkv_rows["decode_1_bf16"][k]
                                      for k in step_keys}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
