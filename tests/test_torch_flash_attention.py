"""The port's flash attention against the JAX Pallas kernel.

The same numpy inputs (from a seed) go through the Pallas kernel in
interpret mode (``repro.kernels.flash_attention``, as tests/test_kernels.py
runs it) and through the port's wrapper on CPU tensors, which computes
the plain PyTorch version. atol 2e-5 is tests/test_kernels.py's float32
tolerance. The CUDA kernel itself runs only on a card (chip_smoke.py and
the card test at the end).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as fa_jax
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as FA

ATOL = 2e-5


def _qkv(seed, B, Sq, Sk, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, D)).astype(np.float32))


def _both(q, k, v, *, block=8, **kw):
    """(JAX Pallas in interpret mode, port on CPU tensors) as numpy."""
    jkw = {k_: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for k_, a in kw.items()}
    want = fa_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  block_q=block, block_k=block, interpret=True, **jkw)
    tkw = {k_: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for k_, a in kw.items()}
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), block_q=block,
                              block_k=block, **tkw)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("D", [16, 26])
def test_kv_lengths_with_zero_row(D):
    q, k, v = _qkv(0, 4, 16, 24, 4, 2, D)
    lens = np.array([24, 9, 1, 0], np.int32)
    want, got = _both(q, k, v, causal=False, kv_lengths=lens)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(got[3]).max() == 0.0


@pytest.mark.parametrize("D", [16, 26])
def test_segments_with_gaps(D):
    """Packed rows at block-aligned offsets with -1 gaps, an interior -1
    and a ragged tail (S=37 pads to 40 inside both wrappers)."""
    S = 37
    seg = np.full((2, S), -1, np.int32)
    seg[0, 0:5], seg[0, 8:19], seg[0, 24:37] = 0, 1, 2
    seg[0, 10] = -1
    seg[1, 0:30] = 0
    q, k, v = _qkv(1, 2, S, S, 4, 4, D)
    want, got = _both(q, k, v, causal=False, segment_ids=seg)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(got[seg == -1]).max() == 0.0


@pytest.mark.parametrize("shape", [(1, 64, 64, 8, 2, 16), (2, 33, 65, 4, 1, 26),
                                   (1, 48, 48, 4, 4, 26)])
@pytest.mark.parametrize("window", [0, 16])
def test_causal_window_gqa(shape, window):
    B, Sq, Sk, H, KV, D = shape
    q, k, v = _qkv(2, B, Sq, Sk, H, KV, D)
    want, got = _both(q, k, v, causal=True, window=window, block=16)
    np.testing.assert_allclose(got, want, atol=ATOL)
    ref_out = ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(ref_out), atol=ATOL)


def test_noncausal_unmasked_matches_reference():
    q, k, v = _qkv(3, 2, 16, 40, 4, 4, 26)
    want, got = _both(q, k, v, causal=False)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_plain_matches_attention_ref_with_lengths():
    q, k, v = _qkv(4, 3, 12, 12, 6, 3, 26)
    lens = np.array([12, 5, 0], np.int32)
    want = ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False, kv_lengths=jnp.asarray(lens))
    got = FA.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=False,
                                   kv_lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_strided_views_of_fused_qkv():
    """The text encoder passes q/k/v as views of one (B, S, 3, H, D)
    buffer; the wrapper takes them as they are."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 10, 3, 12, 26)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    lens = torch.tensor([10, 4], dtype=torch.int32)
    got = ops.flash_attention(q, k, v, causal=False, kv_lengths=lens)
    want = FA.flash_attention_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=False,
                                    kv_lengths=lens)
    assert torch.equal(got, want)


def test_cpu_tensors_never_count_a_launch():
    before = FA.flash_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 8, 8, 2, 2, 16))
    ops.flash_attention(q, k, v, causal=True)
    ops.flash_attention(q, k, v, causal=False,
                        kv_lengths=torch.tensor([5], dtype=torch.int32))
    assert FA.flash_attention.launches == before == 0
    assert ops.flash_attention is FA.flash_attention


@pytest.mark.parametrize("kw, exc", [
    (dict(causal=True, kv_lengths=torch.tensor([4])), NotImplementedError),
    (dict(causal=False, kv_lengths=torch.tensor([4]),
          segment_ids=torch.zeros((1, 8), dtype=torch.int32)), ValueError),
])
def test_rejects_what_the_reference_rejects(kw, exc):
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 8, 8, 2, 2, 16))
    with pytest.raises(exc):
        ops.flash_attention(q, k, v, **kw)


def test_segments_need_self_attention():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 8, 16, 2, 2, 16))
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(q, k, v, causal=False,
                            segment_ids=torch.zeros((1, 8), dtype=torch.int32))


def test_cuda_launch_checks_head_dim_before_building():
    """D > 128 is refused on the card side before any build or launch."""
    q = torch.zeros((1, 4, 1, 160))
    with pytest.raises(ValueError, match="head dim 160"):
        FA._launch(q, q, q, causal=False, window=0, scale=1.0,
                   kv_lengths=None, segment_ids=None)
    with pytest.raises(TypeError, match="float32"):
        FA._launch(q.double(), q.double(), q.double(), causal=False,
                   window=0, scale=1.0, kv_lengths=None, segment_ids=None)


def test_build_targets_sm90a_per_source():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    srcs = build.sources()
    assert [s.name for s in srcs] == ["flash_attention.cu"]
    assert build._target(srcs[0]).parent == build.BUILD_DIR
    text = srcs[0].read_text()
    assert "repro/kernels/flash_attention.py::flash_attention" in text
    assert 'extern "C" int repro_flash_attention_fwd' in text


def test_kernel_matches_plain_on_card():
    """Runs only where a CUDA card is present (chip_smoke.py covers the
    same ground at the serving shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(a).to(dev) for a in _qkv(9, 3, 64, 64, 12, 12, 26))
    lens = torch.tensor([64, 17, 0], dtype=torch.int32, device=dev)
    before = FA.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=False, kv_lengths=lens)
    want = FA.flash_attention_plain(q, k, v, causal=False, kv_lengths=lens)
    assert FA.flash_attention.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-4
    assert float(got[2].abs().max()) == 0.0
