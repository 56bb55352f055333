"""Multi-pod dry run: trace every (arch x shape x mesh) step per device.

The port of ``repro.launch.dryrun``. For each combination this starts a
``fake`` process group of 256 (``single``, a (16, 16) mesh) or 512
(``multi``, (2, 16, 16)) ranks in this one process, as rank 0, builds the
production mesh and the sharding policy over it, and runs the step that
``launch.specs.input_specs`` gives (train_step / prefill_step /
serve_step) once on its ``meta`` DTensor inputs under
``analysis.hlo_analyzer.analyze_step``. Nothing is allocated or
computed and no message is sent: the step's aten ops on rank 0's blocks
give the per-device FLOPs, collective bytes and counts, and the
roofline (``analysis.roofline``, H100 constants). One JSON record per
combination goes to ``artifacts/dryrun/``; a failed combination is
recorded as data.

This is the port's one entry point that runs only on the CPU: it
measures placement (what each device would compute, hold and exchange
on 256 or 512 cards), not the card, so it needs no card, touches none,
and runs on any machine with the port.

What the reference records and the port cannot: there is no compiled
module, so ``memory_analysis()`` and ``cost_analysis()`` have no
counterpart. In their place the record holds the local shard bytes of
the step's arguments (``argument_local_bytes``), of its outputs
(``output_local_bytes``) and, for a decode step, of its cache
(``cache_local_bytes``), and the trace's seconds (``t_trace_s``) in
place of lowering and compiling.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mistral-nemo-12b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
      [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from ..analysis import roofline as RL
from ..analysis.hlo_analyzer import analyze_step
from ..configs import ARCHS, SHAPES, get_config
from ..distributed import spmd as SP
from ..distributed.sharding import Policy
from .mesh import make_production_mesh
from .specs import input_specs

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"


def start_fake_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process its
    rank 0: collectives return at once and move nothing. Refuses to start
    beside a running process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "dryrun: a process group is running; the dry run starts its own "
            "fake group of 256 or 512 ranks and needs none beside it")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def local_bytes(tree) -> int:
    """Bytes of this rank's blocks of every tensor in ``tree``."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return 0
    t = tree.to_local() if SP.is_dtensor(tree) else tree
    return t.numel() * t.element_size()


def run_one(arch: str, shape_name: str, mesh_kind: str, *, save=True,
            tuned=False, strategy="2d", out_dir=ARTIFACTS):
    import torch.distributed as dist
    cfg = get_config(arch)
    if strategy == "fsdp":
        # pure-FSDP shards batch over all intra-pod chips: one sample
        # per device at train_4k, so no microbatch accumulation
        cfg = dataclasses.replace(cfg, train_microbatches=1)
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multi"
    chips = 512 if multi else 256
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "chips": chips, "tuned": tuned, "strategy": strategy, "ok": False}
    t0 = time.time()
    start_fake_group(chips)
    try:
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        policy = Policy(cfg, mesh, tuned=tuned, strategy=strategy)
        fn, args = input_specs(cfg, shape, policy)
        rec["argument_local_bytes"] = local_bytes(args)
        if shape.kind == "decode":
            rec["cache_local_bytes"] = local_bytes(args[1])
        outs = []
        t1 = time.time()
        totals = analyze_step(lambda *a: outs.append(fn(*a)), *args)
        rec["t_trace_s"] = time.time() - t1
        rec["output_local_bytes"] = local_bytes(outs)
        rec["collectives_bytes"] = totals.coll
        rec["collectives_count"] = totals.coll_count
        roof = RL.analyze(totals, cfg, shape, chips,
                          experts_2d=tuned and policy.experts_2d)
        rec["roofline"] = roof.as_dict()
        rec["param_count"] = cfg.param_count()
        rec["active_param_count"] = cfg.active_param_count()
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record failures as data
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        SP.forget_groups()
        dist.destroy_process_group()
    rec["t_total_s"] = time.time() - t0
    if save:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = "_tuned" if tuned else ""
        if strategy != "2d":
            suffix += f"_{strategy}"
        out = out_dir / f"{arch}_{shape_name}_{mesh_kind}{suffix}.json"
        out.write_text(json.dumps(rec, indent=1))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tuned", action="store_true",
                    help="apply the §Perf sharding changes (see "
                         "distributed.sharding.Policy)")
    ap.add_argument("--strategy", default="2d", choices=["2d", "fsdp"])
    ap.add_argument("--out", default=str(ARTIFACTS),
                    help="directory of the records (default: the "
                         "checkout's artifacts/dryrun)")
    args = ap.parse_args()

    archs = ARCHS if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                rec = run_one(arch, shape, mk, tuned=args.tuned,
                              strategy=args.strategy, out_dir=args.out)
                status = "OK" if rec["ok"] else "FAIL"
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
                extra = ""
                if rec["ok"]:
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" tc={r['t_compute_s']:.3g}s"
                             f" tm={r['t_memory_s']:.3g}s"
                             f" tcoll={r['t_collective_s']:.3g}s")
                else:
                    extra = " " + rec["error"][:200]
                print(f"[{status}] {arch} x {shape} x {mk}"
                      f" ({rec['t_total_s']:.1f}s){extra}", flush=True)
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
