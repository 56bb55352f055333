"""The port's RWKV6 scan against the JAX Pallas kernel and its oracle.

The same numpy inputs (from a seed) go through
``repro.kernels.rwkv6.rwkv6_scan`` in interpret mode (as
tests/test_kernels.py runs it), through ``repro.kernels.ref.rwkv6_ref``
and through the port's wrapper on CPU tensors, which computes the plain
PyTorch version. atol 1e-4 is tests/test_kernels.py's tolerance. The
CUDA kernel itself runs only on a card (chip_smoke.py and the card test
at the end).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.rwkv6 import rwkv6_scan as rwkv_jax
from repro.models.rwkv import _wkv_scan as wkv_jax
from repro_torch.kernels import build, ops
from repro_torch.kernels import rwkv6 as RW

ATOL = 1e-4
RWKV_SHAPES = [(2, 32, 2, 16), (1, 100, 4, 8), (2, 17, 1, 32), (1, 64, 8, 64)]


def _inputs(seed, B, S, H, n, *, s0=False):
    """r, k, v ~ N(0, 1); w in (0.4, 0.9), the JAX test's decay range;
    u ~ 0.1 N(0, 1); an optional initial state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, n)).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.normal(size=(B, S, H, n)))) * 0.5
         + 0.4).astype(np.float32)
    u = (rng.normal(size=(H, n)) * 0.1).astype(np.float32)
    out = [r, k, v, w, u]
    if s0:
        out.append(rng.normal(size=(B, H, n, n)).astype(np.float32))
    return out


def _decays(rng, shape, kind):
    """w in (0.4, 0.9) ("range", the JAX test's); as the model draws them,
    exp(-exp(w0 + lora)) with w0 = linspace(-6, -1) over the head dim and
    lora ~ 0.5 N(0, 1) ("model"); or the range with a tenth exactly 0 and
    a tenth exactly 1 ("edges")."""
    w = 1.0 / (1.0 + np.exp(-rng.normal(size=shape))) * 0.5 + 0.4
    if kind == "model":
        w = np.exp(-np.exp(np.linspace(-6.0, -1.0, shape[-1])
                           + 0.5 * rng.normal(size=shape)))
    elif kind == "edges":
        pick = rng.random(shape)
        w = np.where(pick < 0.1, 0.0, np.where(pick > 0.9, 1.0, w))
    return w.astype(np.float32)


def _chunked_mirror(r, k, v, w, u, s0, *, chunk, cols):
    """A torch mirror of csrc/rwkv6.cu's algebra: the state split into
    ``cols``-column slices, each run on its own; time in chunks of
    ``chunk`` steps, each chunk as products with no per-step chain:
    A[t,s] = sum_i r_t k_s prod_{s<tau<t} w_tau (u on the diagonal),
    y = (r * a) S + A V, S <- diag(a_L) S + (k * b)^T V, where a and b
    are running products of w (never a log: w may be exactly 0)."""
    B, S, H, n = r.shape
    r, k, v, w = (x.permute(0, 2, 1, 3) for x in (r, k, v, w))  # (B,H,S,n)
    state = (torch.zeros((B, H, n, n)) if s0 is None else s0).clone()
    y = torch.zeros((B, H, S, n))
    for j0 in range(0, n, cols):
        St = state[..., j0:j0 + cols]
        for c0 in range(0, S, chunk):
            T = min(chunk, S - c0)
            R, K, W = (x[:, :, c0:c0 + T] for x in (r, k, w))
            V = v[:, :, c0:c0 + T, j0:j0 + cols]
            a = [torch.ones((B, H, n))]
            for t in range(T):
                a.append(a[-1] * W[:, :, t])
            b = [torch.ones((B, H, n))]
            for s in range(T - 1, 0, -1):
                b.insert(0, b[0] * W[:, :, s])
            ra = R * torch.stack(a[:T], 2)
            kb = K * torch.stack(b, 2)
            A = torch.zeros((B, H, T, T))
            for s in range(T):
                A[:, :, s, s] = (R[:, :, s] * u * K[:, :, s]).sum(-1)
                kp = K[:, :, s]
                for t in range(s + 1, T):
                    A[:, :, t, s] = (R[:, :, t] * kp).sum(-1)
                    kp = kp * W[:, :, t]
            y[:, :, c0:c0 + T, j0:j0 + cols] = ra @ St + A @ V
            St = a[T][..., None] * St + kb.transpose(-1, -2) @ V
        state[..., j0:j0 + cols] = St
    return y.permute(0, 2, 1, 3), state


def _port(*arrays):
    return [a.numpy() for a in ops.rwkv6_scan(*map(torch.from_numpy, arrays))]


@pytest.mark.parametrize("shape", RWKV_SHAPES)
@pytest.mark.parametrize("with_s0", [False, True])
def test_matches_pallas_kernel_and_oracle(shape, with_s0):
    arrays = _inputs(sum(shape) + with_s0, *shape, s0=with_s0)
    y, s = _port(*arrays)
    jarrays = [jnp.asarray(a) for a in arrays]
    yk, sk = rwkv_jax(*jarrays, block_t=16, interpret=True)
    yr, sr = ref.rwkv6_ref(*jarrays)
    for want_y, want_s in ((yk, sk), (yr, sr)):
        np.testing.assert_allclose(y, np.asarray(want_y), atol=ATOL)
        np.testing.assert_allclose(s, np.asarray(want_s), atol=ATOL)


def test_matches_model_scan_order():
    """``models/rwkv.py::_wkv_scan`` returns (state, y); the kernel
    (y, state). The port's model keeps the reference's order."""
    from repro_torch.models.rwkv import _wkv_scan
    arrays = _inputs(3, 1, 9, 2, 16, s0=True)
    s_j, y_j = wkv_jax(*map(jnp.asarray, arrays))
    s_p, y_p = _wkv_scan(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), atol=ATOL)


def test_chained_equals_one_call():
    """Chaining two calls via the state equals one long call — the
    chunked-prefill contract of tests/test_kernels.py."""
    B, S, H, n = 1, 48, 2, 16
    r, k, v, w, u = map(torch.from_numpy, _inputs(4, B, S, H, n))
    y_full, s_full = ops.rwkv6_scan(r, k, v, w, u)
    h = S // 2
    y1, s1 = ops.rwkv6_scan(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u)
    y2, s2 = ops.rwkv6_scan(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=ATOL)


def test_single_step_decode():
    """S=1, the decode step, from a nonzero state: against the Pallas
    kernel and the oracle."""
    arrays = _inputs(5, 2, 1, 4, 64, s0=True)
    y, s = _port(*arrays)
    jarrays = [jnp.asarray(a) for a in arrays]
    for want_y, want_s in (rwkv_jax(*jarrays, interpret=True),
                           ref.rwkv6_ref(*jarrays)):
        np.testing.assert_allclose(y, np.asarray(want_y), atol=ATOL)
        np.testing.assert_allclose(s, np.asarray(want_s), atol=ATOL)


@pytest.mark.parametrize("bad, match", [
    ("u", "u shape"), ("s0", "s0 shape"), ("k", "k shape")])
def test_rejects_bad_shapes(bad, match):
    r, k, v, w, u, s0 = map(torch.from_numpy,
                            _inputs(6, 1, 4, 2, 8, s0=True))
    args = dict(r=r, k=k, v=v, w=w, u=u, s0=s0)
    args[bad] = args[bad][..., :4]
    with pytest.raises(ValueError, match=match):
        ops.rwkv6_scan(**args)


def test_cuda_launch_checks_before_building():
    """Refusals on the card side come before any build or launch."""
    r, k, v, w, u = map(torch.from_numpy, _inputs(7, 1, 3, 1, 80))
    with pytest.raises(ValueError, match="head dim 80"):
        RW._launch(r, k, v, w, u, None)
    r, k, v, w, u = map(torch.from_numpy, _inputs(7, 1, 3, 2, 16))
    with pytest.raises(TypeError, match="float32"):
        RW._launch(r.double(), k, v, w, u, None)
    with pytest.raises(ValueError, match="contiguous"):
        RW._launch(r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   w.transpose(1, 2), u, None)


def test_source_names_what_it_replaces():
    text = (build.CSRC / "rwkv6.cu").read_text()
    assert "repro/kernels/rwkv6.py::rwkv6_scan" in text
    assert 'extern "C" int repro_rwkv6_scan' in text


def test_kernel_matches_plain_on_card():
    """Runs only where a CUDA card is present (chip_smoke.py covers the
    same ground at the serving shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    arrays = [torch.from_numpy(a).to(dev)
              for a in _inputs(8, 1, 100, 4, 64, s0=True)]
    before = RW.rwkv6_scan.launches
    y, s = ops.rwkv6_scan(*arrays)
    yp, sp = RW.rwkv6_scan_plain(*arrays)
    assert RW.rwkv6_scan.launches == before + 1
    assert float((y - yp).abs().max()) <= ATOL
    assert float((s - sp).abs().max()) <= ATOL


@pytest.mark.parametrize("chunk", RW.CHUNKS)
@pytest.mark.parametrize("decay", ["range", "model", "edges"])
@pytest.mark.parametrize("S", [1, 17, 45])
def test_chunked_algebra_matches_pallas_oracle_and_plain(chunk, decay, S):
    """The kernel's chunked, column-split decomposition, mirrored in torch
    at each chunk length plan_chunks can pick, against the Pallas kernel
    in interpret mode, the oracle and the port's plain version, from a
    nonzero state. S=45 is a multiple of neither chunk length."""
    B, H, n = 1, 2, 32
    rng = np.random.default_rng(100 + S + chunk)
    r, k, v = (rng.normal(size=(B, S, H, n)).astype(np.float32)
               for _ in range(3))
    w = _decays(rng, (B, S, H, n), decay)
    u = (rng.normal(size=(H, n)) * 0.1).astype(np.float32)
    s0 = rng.normal(size=(B, H, n, n)).astype(np.float32)
    arrays = [r, k, v, w, u, s0]
    y, s = _chunked_mirror(*map(torch.from_numpy, arrays), chunk=chunk,
                           cols=RW.COLS_PER_BLOCK)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    jarrays = [jnp.asarray(a) for a in arrays]
    yp, sp = RW.rwkv6_scan_plain(*map(torch.from_numpy, arrays))
    for want_y, want_s in (rwkv_jax(*jarrays, block_t=16, interpret=True),
                           ref.rwkv6_ref(*jarrays), (yp, sp)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=ATOL)


@pytest.mark.parametrize("chunk", RW.CHUNKS)
def test_chunked_algebra_chains_through_s0(chunk):
    """Two mirrored calls chained through the state equal one call and
    the plain version, with the split inside a chunk."""
    B, S, H, n = 1, 50, 2, 16
    rng = np.random.default_rng(7 + chunk)
    r, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, n)).astype(
        np.float32)) for _ in range(3))
    w = torch.from_numpy(_decays(rng, (B, S, H, n), "model"))
    u = torch.from_numpy((rng.normal(size=(H, n)) * 0.1).astype(np.float32))
    mirror = lambda *a: _chunked_mirror(*a, chunk=chunk,  # noqa: E731
                                        cols=RW.COLS_PER_BLOCK)
    h = 21
    y1, s1 = mirror(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, None)
    y2, s2 = mirror(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s1)
    yp, sp = RW.rwkv6_scan_plain(r, k, v, w, u)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), yp.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(s2.numpy(), sp.numpy(), atol=ATOL)


@pytest.mark.parametrize("shape, plan", [
    ((1, 520, 32, 64), (16, 4)),      # RWKV6-1.6B prefill, a 520-token prompt
    ((1, 512, 32, 64), (16, 4)),      # ... the 512-token system prompt
    ((1, 1, 32, 64), (1, 4)),         # ... a decode step: the step kernel
    ((2, 17, 1, 32), (16, 2)),
    ((1, 100, 4, 8), (16, 1)),
])
def test_plan_chunks_at_path_shapes(shape, plan):
    assert RW.plan_chunks(*shape) == plan
    chunk, col_blocks = plan
    assert chunk in RW.CHUNKS
    assert col_blocks * RW.COLS_PER_BLOCK >= shape[3]
    # more blocks than (batch, head) pairs wherever a head has more
    # columns than one block owns
    assert col_blocks > 1 or shape[3] <= RW.COLS_PER_BLOCK


def test_plan_chunks_refuses_wide_heads():
    with pytest.raises(ValueError, match="head dim 80"):
        RW.plan_chunks(1, 8, 2, 80)


def test_launch_refuses_a_chunk_the_kernel_does_not_compile():
    r, k, v, w, u = map(torch.from_numpy, _inputs(9, 1, 3, 2, 16))
    with pytest.raises(ValueError, match="chunk=8"):
        RW._launch(r, k, v, w, u, None, chunk=8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(1, 40, 2, 64), (2, 1, 3, 64),
                                   (1, 19, 2, 20)])
def test_half_rkv_equal_float32_on_up_cast_inputs(shape, dtype):
    """r, k and v in bf16 or fp16 with float32 w, u and s0 (as the bf16
    model passes them): y and the state float32, bit-equal to the float32
    call on the up-cast inputs, and within the file's 1e-4 of the Pallas
    kernel in interpret mode on the same half-type inputs."""
    r, k, v, w, u, s0 = _inputs(30 + shape[1], *shape, s0=True)
    half = [torch.from_numpy(a).to(dtype) for a in (r, k, v)]
    rest = [torch.from_numpy(a) for a in (w, u, s0)]
    y, s = ops.rwkv6_scan(*half, *rest)
    y32, s32 = ops.rwkv6_scan(*(a.float() for a in half), *rest)
    assert y.dtype == s.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(s, s32)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    yk, sk = rwkv_jax(*(jnp.asarray(a, jdt) for a in (r, k, v)),
                      *(jnp.asarray(a) for a in (w, u, s0)), block_t=16,
                      interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_launch_takes_half_rkv_and_refuses_mixed(dtype):
    """bf16/fp16 r/k/v with float32 w/u/s0 pass the dtype check (the chunk
    check after it is what refuses chunk=8 here); r/k/v of mixed types, or
    a half-type w, u or s0, are refused with a TypeError naming float32,
    all before any build or launch."""
    r, k, v, w, u, s0 = map(torch.from_numpy, _inputs(10, 1, 3, 2, 16,
                                                      s0=True))
    rh, kh, vh = (a.to(dtype) for a in (r, k, v))
    for s in (None, s0):
        with pytest.raises(ValueError, match="chunk=8"):
            RW._launch(rh, kh, vh, w, u, s, chunk=8)
    other = torch.float16 if dtype == torch.bfloat16 else torch.bfloat16
    bad = [(rh, kh.to(other), vh, w, u, s0), (rh, kh, v, w, u, s0),
           (rh, kh, vh, w.to(dtype), u, s0), (rh, kh, vh, w, u.to(dtype), s0),
           (rh, kh, vh, w, u, s0.to(dtype))]
    for args in bad:
        with pytest.raises(TypeError, match="float32"):
            RW._launch(*args, chunk=8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_kernel_equals_float32_launch_on_card(dtype):
    """Runs only where a CUDA card is present: bf16/fp16 r/k/v bit-equal
    to the float32 launch on the up-cast inputs at every chunk length."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(dev)
                         for a in _inputs(11, 1, 45, 4, 64, s0=True))
    half = [a.to(dtype) for a in (r, k, v)]
    for chunk in RW.CHUNKS:
        y, s = RW._launch(*half, w, u, s0, chunk=chunk)
        y32, s32 = RW._launch(*(a.float() for a in half), w, u, s0,
                              chunk=chunk)
        assert torch.equal(y, y32) and torch.equal(s, s32)
