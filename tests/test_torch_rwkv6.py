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
