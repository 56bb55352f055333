"""The port's per-device op walker (``repro_torch.analysis.hlo_analyzer``)
on the cases of ``tests/test_distributed_perf.py``'s analyzer tests: a
3-layer matmul loop counts L x 2BDD (as the reference's ``analyze_hlo``
counts it on the compiled scan); inside ``trips(7)`` an all-gather of an
f32[4,8] result counts 7 x 128 bytes and 7 calls, an all-reduce outside
it 128 bytes; a row-sharded DTensor matmul counts one rank's block, not
the global product; and on ``meta`` tensors the plain scans (RWKV6
forward and backward, Mamba's selective scan) count, one step inside
``trips(S)``, exactly what their S-step walks count on the CPU, and
under autograd the step's backward counts S times too.

The process-group cases run in a subprocess (a 4-rank ``fake`` group),
so no group outlives this file."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo_analyzer as JH
from repro_torch.analysis import hlo_analyzer as H
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import rwkv6 as RW
from repro_torch.models import ssm as SSM

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")

FAKE_GROUP_CASES = r"""
import json
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as fc
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.analysis import hlo_analyzer as H

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
try:
    def collectives(x):
        with H.trips(7):
            fc.all_gather_tensor(x, 0, dist.group.WORLD).sum()
        dist.all_reduce(torch.empty(4, 8, device="meta"))
    coll = H.analyze_step(collectives, torch.empty(1, 8, device="meta"))
    mesh = init_device_mesh("cpu", (4,))
    a = DTensor.from_local(torch.empty(64, 4096, device="meta"), mesh,
                           [Shard(0)], run_check=False)
    b = DTensor.from_local(torch.empty(4096, 1024, device="meta"), mesh,
                           [Replicate()], run_check=False)
    mm = H.analyze_step(torch.matmul, a, b)
    print(json.dumps({"coll": coll.__dict__, "mm": mm.__dict__}))
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def fake_group_totals():
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", FAKE_GROUP_CASES],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_layer_loop_flops_match_reference():
    L, B, D = 3, 4, 16

    def f(w, x):
        c = x
        for i in range(L):
            c = torch.tanh(c @ w[i])
        return c.sum()
    t = H.analyze_step(f, torch.zeros((L, D, D)), torch.zeros((B, D)))
    assert t.flops == L * 2 * B * D * D

    def jf(w, x):
        c, _ = jax.lax.scan(lambda c, wi: (jnp.tanh(c @ wi), None), x, w)
        return c.sum()
    comp = jax.jit(jf).lower(jnp.zeros((L, D, D)), jnp.zeros((B, D))).compile()
    assert JH.analyze_hlo(comp.as_text()).flops == t.flops
    assert H.COLLECTIVES == JH.COLLECTIVES
    assert sum(t.coll.values()) == sum(t.coll_count.values()) == 0


def test_trips_multiply_collectives(fake_group_totals):
    t = fake_group_totals["coll"]
    ag = 4 * 8 * 4                      # f32[4,8] bytes
    assert t["coll"]["all-gather"] == 7 * ag
    assert t["coll_count"]["all-gather"] == 7
    assert t["coll"]["all-reduce"] == ag
    assert t["coll_count"]["all-reduce"] == 1
    assert t["flops"] == 0


def test_dtensor_matmul_counts_one_rank(fake_group_totals):
    """A (256, 4096) x (4096, 1024) product, rows sharded over 4 ranks:
    one rank multiplies its (64, 4096) block, 5.4e8 FLOPs, not the
    global product's 2.15e9."""
    t = fake_group_totals["mm"]
    assert t["flops"] == 2 * 64 * 4096 * 1024
    assert t["flops"] != 2 * 256 * 4096 * 1024
    assert sum(t["coll_count"].values()) == 0


def _same(a, b):
    assert a.flops == b.flops and a.bytes == b.bytes
    assert a.coll == b.coll and a.coll_count == b.coll_count


def _rwkv_inputs(device, B=2, S=64, H_=3, n=8):
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.random(s, dtype=np.float32)).to(device)  # noqa: E731
    return (f(B, S, H_, n), f(B, S, H_, n), f(B, S, H_, n), f(B, S, H_, n),
            f(H_, n), f(B, H_, n, n), f(B, S, H_, n), f(B, H_, n, n))


@pytest.mark.parametrize("backward", (False, True))
def test_meta_rwkv6_scan_counts_the_walk(backward):
    counts = {}
    for dev in ("cpu", "meta"):
        r, k, v, w, u, s0, dy, dsf = _rwkv_inputs(dev)
        if backward:
            fn, args = RW.rwkv6_scan_backward_plain, (r, k, v, w, u, s0, dy, dsf)
        else:
            fn, args = RW.rwkv6_scan_plain, (r, k, v, w, u, s0)
        counts[dev] = H.analyze_step(fn, *args)
        outs = fn(*args)
        assert [o.shape for o in outs] == [o.shape for o in fn(*_rwkv_inputs(
            "cpu")[:len(args)])]
    assert counts["cpu"].flops > 0
    _same(counts["meta"], counts["cpu"])


def test_meta_ssm_scan_counts_the_walk():
    cfg = reduced(get_config("jamba-v0.1-52b"))
    di, st = cfg.mamba.d_inner(cfg.d_model), cfg.mamba.d_state
    rng = np.random.default_rng(1)
    counts = {}
    for dev in ("cpu", "meta"):
        f = lambda *s: torch.from_numpy(  # noqa: E731
            rng.standard_normal(s).astype(np.float32)).to(dev)
        p = {"A_log": f(di, st)}
        args = (p, f(2, 64, di), f(2, 64, di), f(2, 64, st), f(2, 64, st),
                f(2, di, st))
        counts[dev] = H.analyze_step(SSM._ssm_scan, *args)
        h, ys = SSM._ssm_scan(*args)
        assert tuple(h.shape) == (2, di, st) and tuple(ys.shape) == (2, 64, di)
    assert counts["cpu"].flops == 64 * 2 * 2 * di * st
    _same(counts["meta"], counts["cpu"])


def test_meta_ssm_scan_backward_counts_the_walk():
    """Under autograd the step's backward, run after ``trips`` exits,
    counts S times too: the meta scan's forward and backward FLOPs equal
    the S-step walk's."""
    cfg = reduced(get_config("jamba-v0.1-52b"))
    di, st = cfg.mamba.d_inner(cfg.d_model), cfg.mamba.d_state
    rng = np.random.default_rng(2)
    flops = {}
    for dev in ("cpu", "meta"):
        f = lambda *s: torch.from_numpy(  # noqa: E731
            rng.standard_normal(s).astype(np.float32)).to(dev).requires_grad_()
        args = ({"A_log": f(di, st)}, f(2, 64, di), f(2, 64, di),
                f(2, 64, st), f(2, 64, st), f(2, di, st))

        def step(*a):
            h, ys = SSM._ssm_scan(*a)
            (h.sum() + ys.sum()).backward()
        flops[dev] = H.analyze_step(step, *args).flops
    assert flops["cpu"] == 3 * 64 * 2 * 2 * di * st
    assert flops["meta"] == flops["cpu"]


def test_trips_outside_analyze_step_and_restores():
    with H.trips(5):
        pass
    c = H._Counter()
    with c:
        with H.trips(3):
            with H.trips(4):
                torch.ones(2) @ torch.ones(2)
        torch.ones(2) @ torch.ones(2)
    assert c.mult == 1.0
    assert c.totals.flops == 12 * 4 + 4
