"""The port's decode attention against the JAX Pallas kernel and its oracle.

The same numpy inputs (from a seed) go through
``repro.kernels.decode_attention.decode_attention`` in interpret mode (as
tests/test_decode_kernel.py runs it), through
``repro.models.attention.plain_attention_vs_cache`` (that kernel's
oracle) and through the port's wrapper on CPU tensors, which computes
the plain PyTorch version. float32 at 3e-5, tests/test_decode_kernel.py's
tolerance; bfloat16 within one bf16 ulp of the reference (both sides
round one float32 result once). The CUDA kernel itself runs only on a
card (chip_smoke.py and the card test at the end).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as da_jax
from repro.models.attention import plain_attention_vs_cache as oracle_jax
from repro_torch.kernels import build, ops
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import attention as A

ATOL = 3e-5
SHAPES = [
    (2, 64, 8, 4, 16),    # B, W, H, KV, D
    (1, 100, 4, 4, 32),   # MHA, W not a multiple of 16
    (2, 48, 8, 2, 64),    # GQA 4:1
]


def _inputs(seed, B, W, H, KV, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 1, H, D)).astype(dtype),
            rng.normal(size=(B, W, KV, D)).astype(dtype),
            rng.normal(size=(B, W, KV, D)).astype(dtype))


def _ring_pos(W, t):
    """Slot s holds a position with s == pos % W in the test's ring; some
    slots never written (-1), as tests/test_decode_kernel.py builds it."""
    pos = np.array([(t - (s % (W + 3))) for s in range(W)], np.int32)
    pos[::7] = -1
    return pos


def _bf16_ulp(x):
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("window", [0, 24])
def test_matches_pallas_kernel_and_oracle(shape, window):
    B, W, H, KV, D = shape
    q, k, v = _inputs(sum(shape) + window, B, W, H, KV, D)
    t = W + 5
    pos = _ring_pos(W, t)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
             jnp.int32(t))
    kernel = np.asarray(da_jax(*jargs, window=window, block_k=16,
                               interpret=True))
    oracle = np.asarray(oracle_jax(*jargs, window=window,
                                   scale=1.0 / math.sqrt(D)))
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pos), t,
                               window=window).numpy()
    np.testing.assert_allclose(got, kernel, atol=ATOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL)
    # the model's alias is the same plain version
    again = A.plain_attention_vs_cache(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), torch.tensor(t, dtype=torch.int32),
        window=window, scale=1.0 / math.sqrt(D)).numpy()
    np.testing.assert_array_equal(again, got)


def test_bf16_within_one_ulp():
    B, W, H, KV, D = 1, 32, 4, 2, 16
    q, k, v = _inputs(11, B, W, H, KV, D)
    pos = np.arange(W, dtype=np.int32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jargs = (jq, jk, jv, jnp.asarray(pos), jnp.int32(W - 1))
    kernel = np.asarray(da_jax(*jargs, block_k=16, interpret=True)
                        .astype(jnp.float32))
    oracle = np.asarray(oracle_jax(*jargs, window=0, scale=1.0 / math.sqrt(D))
                        .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(pos), W - 1)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (kernel, oracle):
        assert (np.abs(got - want) <= _bf16_ulp(want)).all(), \
            np.abs(got - want).max()


@pytest.mark.parametrize("W, block_k", [(20, 8), (16, 8)])
def test_all_invalid_cache_is_the_oracles_mean(W, block_k):
    """A cache with no valid slot: every slot scores -1e30, so the
    oracle's softmax weighs all W slots equally and returns the plain
    mean of v. The port follows the oracle. (The Pallas kernel pads W to
    a multiple of block_k and its padded zero slots join that mean, so it
    agrees only when W is a multiple of block_k: ROADMAP queue 3. The
    server never reads such a cache: slot t is written first.)"""
    B, H, KV, D = 1, 2, 2, 8
    q, k, v = _inputs(W, B, W, H, KV, D)
    pos = np.full((W,), -1, np.int32)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pos),
                               3).numpy()
    oracle = np.asarray(oracle_jax(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   jnp.int32(3), window=0,
                                   scale=1.0 / math.sqrt(D)))
    mean = np.repeat(v.mean(axis=1), H // KV, axis=1)[:, None]
    np.testing.assert_allclose(oracle, mean, atol=1e-6)
    np.testing.assert_allclose(got, mean, atol=1e-6)
    assert np.isfinite(got).all()
    kernel = np.asarray(da_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), jnp.int32(3),
                               block_k=block_k, interpret=True))
    if W % block_k == 0:
        np.testing.assert_allclose(got, kernel, atol=1e-6)


def test_t_as_device_scalar_equals_int():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 24, 4, 2, 16))
    pos = torch.from_numpy(_ring_pos(24, 30))
    a = ops.decode_attention(q, k, v, pos, 30, window=10)
    b = ops.decode_attention(q, k, v, pos, torch.tensor(30, dtype=torch.int32),
                             window=10)
    assert torch.equal(a, b)


@pytest.mark.parametrize("change, exc, match", [
    (dict(q_tokens=2), ValueError, "one query token"),
    (dict(KV=3), ValueError, "multiple of KV"),
])
def test_rejects_bad_shapes(change, exc, match):
    B, W, H, KV, D = 1, 16, 4, change.get("KV", 2), 8
    q = torch.zeros((B, change.get("q_tokens", 1), H, D))
    k = torch.zeros((B, W, KV, D))
    with pytest.raises(exc, match=match):
        ops.decode_attention(q, k, k, torch.arange(W, dtype=torch.int32), 3)


def test_cuda_launch_checks_before_building():
    """Refusals on the card side come before any build or launch."""
    q = torch.zeros((1, 1, 2, 160))
    k = torch.zeros((1, 8, 2, 160))
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim 160"):
        DA._launch(q, k, k, pos, 3, window=0, scale=1.0)
    q, k = q[..., :16], k[..., :16]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        DA._launch(q.double(), k.double(), k.double(), pos, 3, window=0,
                   scale=1.0)
    with pytest.raises(ValueError, match="slot_pos shape"):
        DA._launch(q, k, k, pos[:5], 3, window=0, scale=1.0)


@pytest.mark.parametrize("W", [1, 20, 37, 64, 1024, 4096])
@pytest.mark.parametrize("B, KV, G", [(1, 8, 4), (2, 8, 4), (1, 2, 2),
                                      (1, 1, 1), (4, 4, 1), (1, 8, 6),
                                      (64, 8, 4)])
def test_split_plan_covers_the_window_once(B, KV, G, W):
    """The chunks cover [0, W) once, in order, none empty, and their count
    stays within the kernel's cluster size and W."""
    nsplit, chunk = DA.plan_splits(B, KV, G, W)
    assert 1 <= nsplit <= min(DA.MAX_SPLIT, W)
    spans = [(i * chunk, min(W, (i + 1) * chunk)) for i in range(nsplit)]
    assert spans[0][0] == 0 and spans[-1][1] == W
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(nsplit - 1))


def test_split_plan_fills_one_wave_at_mistral_width():
    # B=1, KV=8, G=4: 8 blocks a chunk, 16 chunks of 64 slots, 128 blocks
    assert DA.plan_splits(1, 8, 4, 1024) == (16, 64)
    assert DA.plan_splits(2, 8, 4, 1024) == (8, 128)
    assert DA.plan_splits(1, 8, 4, 20) == (10, 2)


def test_source_names_what_it_replaces():
    text = (build.CSRC / "decode_attention.cu").read_text()
    assert "repro/kernels/decode_attention.py::decode_attention" in text
    assert 'extern "C" int repro_decode_attention' in text


def test_kernel_matches_plain_on_card():
    """Runs only where a CUDA card is present (chip_smoke.py covers the
    same ground at the serving shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(a).to(dev) for a in _inputs(9, 2, 48, 8, 2, 64))
    pos = torch.from_numpy(_ring_pos(48, 53)).to(dev)
    before = DA.decode_attention.launches
    got = ops.decode_attention(q, k, v, pos, 53, window=24)
    want = DA.decode_attention_plain(q, k, v, pos, 53, window=24)
    assert DA.decode_attention.launches == before + 1
    assert float((got - want).abs().max()) <= ATOL
    # chip_smoke.py's split-W edges: (B, W, H, KV, D, t, window, pos, bf16)
    full = np.full((1024,), -1, np.int32)
    # slot s holds the last position p <= t with p % W == s (-1: none yet)
    ring = lambda W, t: np.array([max(t - (t - s) % W, -1)  # noqa: E731
                                  for s in range(W)], np.int32)
    cases = [(1, 1024, 32, 8, 128, 2, 0, ring(1024, 2), True),
             (1, 1024, 32, 8, 128, 2, 0, full, True),
             (1, 1024, 32, 8, 128, 1535, 48, ring(1024, 1535), True),
             (1, 20, 32, 8, 128, 29, 0, _ring_pos(20, 29), False),
             (1, 37, 32, 8, 128, 46, 0, _ring_pos(37, 46), False),
             (2, 1024, 32, 8, 128, 700, 0, ring(1024, 700), True),
             (1, 40, 6, 3, 12, 50, 30, ring(40, 50), True)]
    for i, (B, W, H, KV, D, t, window, pos, bf16) in enumerate(cases):
        q, k, v = (torch.from_numpy(a).to(dev) for a in
                   _inputs(20 + i, B, W, H, KV, D))
        if bf16:
            q, k, v = (x.bfloat16() for x in (q, k, v))
        pos = torch.from_numpy(pos).to(dev)
        got = ops.decode_attention(q, k, v, pos, t, window=window).float()
        want = DA.decode_attention_plain(q, k, v, pos, t,
                                         window=window).float()
        assert torch.isfinite(got).all()
        if bf16:
            ulp = torch.from_numpy(_bf16_ulp(want.cpu().numpy())).to(dev)
            assert bool(((got - want).abs() <= ulp).all()), (i, W, t)
        else:
            assert float((got - want).abs().max()) <= ATOL, (i, W, t)
