"""The port's dry run (``repro_torch.launch.dryrun``).

* Reference parity on the 1x1 mesh: the per-device FLOPs that
  ``analysis.hlo_analyzer.analyze_step`` counts over the placed step of
  ``launch.specs.input_specs`` (meta DTensors on a one-rank gloo mesh)
  equal the reference's ``analyze_hlo`` over the compiled step of its
  ``input_specs`` on its host mesh, for reduced Mistral-NeMo, OLMoE and
  RWKV6 at decode, prefill and train (S=64, batch 2). One case differs
  by a stated amount: RWKV6's training step, where the port's explicit
  scan backward (``kernels/rwkv6.py::rwkv6_scan_backward_plain``) forms
  dk and dv as two (B, H, n) x (n, n) products a step, and the
  reference's autodiff of its jnp scan forms them as elementwise
  products and sums, which the HLO walker counts as no dot.
* One live combination, in a subprocess (a 256-rank fake group):
  ``olmoe-1b-7b`` x ``decode_32k`` x ``single``.
* The mirror of ``tests/test_system.py::test_dryrun_artifacts_complete``
  over the committed ``artifacts/dryrun/``: every arch x shape x mesh
  recorded ok, with no field of the reference's compiled module.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch.distributed as dist

from repro.analysis.hlo_analyzer import analyze_hlo
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.distributed.sharding import Policy as JPolicy
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.launch.specs import input_specs as jinput_specs
from repro_torch.analysis.hlo_analyzer import analyze_step
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced
from repro_torch.distributed.sharding import Policy
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.launch.specs import input_specs

ROOT = Path(__file__).resolve().parents[1]
# fields of the reference's compiled module, which the port has not
NOT_MEASURED = ("cost", "temp_size_in_bytes", "argument_size_in_bytes",
                "output_size_in_bytes", "alias_size_in_bytes",
                "generated_code_size_in_bytes", "t_lower_s", "t_compile_s")


@pytest.fixture(scope="module")
def mesh():
    made = not dist.is_initialized()
    m = MESH.make_host_mesh("cpu")
    yield m
    if made:
        MESH.close_mesh()
        assert not dist.is_initialized()


def _shape(table, kind):
    return dataclasses.replace(table[kind], seq_len=64, global_batch=2)


@pytest.mark.parametrize("shape", ("decode_32k", "prefill_32k", "train_4k"))
@pytest.mark.parametrize("arch", ("mistral-nemo-12b", "olmoe-1b-7b",
                                  "rwkv6-1.6b"))
def test_flops_match_reference_on_host_mesh(mesh, arch, shape):
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jmesh = jmake_host_mesh()
    fn, args = jinput_specs(jcfg, _shape(JSHAPES, shape), JPolicy(jcfg, jmesh))
    with jmesh:
        want = analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops
    s = _shape(SHAPES, shape)
    fn, args = input_specs(cfg, s, Policy(cfg, mesh))
    got = analyze_step(fn, *args).flops
    if arch == "rwkv6-1.6b" and shape == "train_4k":
        # dk and dv: two (B, H, n) x (n, n) products a step and a layer
        want += 2 * (2 * cfg.n_layers * s.seq_len * s.global_batch
                     * cfg.d_model * cfg.rwkv_head_dim)
    assert got == want


def test_dryrun_refuses_a_running_group(mesh):
    with pytest.raises(RuntimeError, match="process group is running"):
        DR.start_fake_group(256)


def test_one_combination_live():
    code = ("import json; from repro_torch.launch.dryrun import run_one; "
            "print(json.dumps(run_one('olmoe-1b-7b', 'decode_32k', "
            "'single', save=False)))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.splitlines()[-1])
    assert rec["ok"], rec.get("traceback")
    assert rec["chips"] == 256 and rec["mesh"] == "single"
    roof = rec["roofline"]
    assert roof["flops_per_device"] > 0
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert rec["collectives_count"]["all-gather"] > 0
    assert rec["cache_local_bytes"] < rec["argument_local_bytes"]
    assert not set(NOT_MEASURED) & set(rec)


def test_dryrun_artifacts_complete():
    """The committed dry-run sweep covers all 40 pairs x 2 meshes OK."""
    art = ROOT / "artifacts" / "dryrun"
    recs = [json.loads(p.read_text()) for p in art.glob("*.json")]
    ok = {(r["arch"], r["shape"], r["mesh"]) for r in recs if r["ok"]}
    missing = [(a, s, m) for a in ARCHS for s in SHAPES
               for m in ("single", "multi") if (a, s, m) not in ok]
    assert not missing, f"missing/failed dry-runs: {missing[:5]}"
    assert len(recs) == 80
    for r in recs:
        assert not set(NOT_MEASURED) & set(r), r["arch"]
        assert r["chips"] == (512 if r["mesh"] == "multi" else 256)
