"""The port's flash attention against the JAX Pallas kernel.

The same numpy inputs (from a seed) go through the Pallas kernel in
interpret mode (``repro.kernels.flash_attention``, as tests/test_kernels.py
runs it) and through the port's wrapper on CPU tensors, which computes
the plain PyTorch version. atol 2e-5 is tests/test_kernels.py's float32
tolerance. The CUDA kernel itself runs only on a card (chip_smoke.py and
the card test at the end).
"""
import math

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


@pytest.mark.parametrize("which", [0, 1, 2], ids=["q", "k", "v"])
def test_raises_under_autograd_and_runs_without_it(which):
    """The kernel has no backward: with grad mode on and any of q, k, v
    requiring grad the call raises (here on the CPU, as on the card) and
    counts nothing; under ``no_grad`` and ``inference_mode`` it runs."""
    qkv = [torch.from_numpy(a) for a in _qkv(9, 1, 8, 8, 2, 2, 16)]
    qkv[which].requires_grad_(True)
    calls = FA.flash_attention.calls
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(*qkv, causal=False)
    assert FA.flash_attention.calls == calls
    with torch.no_grad():
        a = ops.flash_attention(*qkv, causal=False)
    with torch.inference_mode():
        b = ops.flash_attention(*qkv, causal=False)
    assert torch.equal(a, b) and not a.requires_grad
    assert FA.flash_attention.calls == calls + 2


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_launch_takes_half_types_and_refuses_others(dtype):
    """bf16 and fp16 q/k/v pass the dtype check (the head-dim check after
    it is what refuses D=160 here); float64 and mixed types are refused
    with a TypeError naming float32, all before any build or launch."""
    q = torch.zeros((1, 4, 1, 160), dtype=dtype)
    with pytest.raises(ValueError, match="head dim 160"):
        FA._launch(q, q, q, causal=True, window=0, scale=1.0,
                   kv_lengths=None, segment_ids=None)
    q = torch.zeros((1, 4, 1, 16), dtype=dtype)
    for k in (q.float(), q.double()):
        with pytest.raises(TypeError, match="float32"):
            FA._launch(q, k, k, causal=True, window=0, scale=1.0,
                       kv_lengths=None, segment_ids=None)
    with pytest.raises(TypeError, match="float32"):
        FA._launch(q.double(), q.double(), q.double(), causal=True,
                   window=0, scale=1.0, kv_lengths=None, segment_ids=None)


# mantissa bits: one step of the type at a value's size is 2^(e - bits)
MANTISSA = {"bfloat16": 7, "float16": 10}


def _step(x, dtype):
    """One step of ``dtype`` at the size of ``x``'s largest element."""
    x = np.abs(np.asarray(x, np.float32)).max()
    return 2.0 ** (np.floor(np.log2(x)) - MANTISSA[dtype])


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_inputs_match_pallas_and_keep_their_dtype(dtype, window):
    """q, k and v in bf16 or fp16: the plain version, like the Pallas body,
    computes in float32 and returns q's dtype, within one step of the
    output's scale of the Pallas kernel in interpret mode (both round a
    float32 result once; the sums run in another order)."""
    q, k, v = _qkv(10 + window, 1, 40, 40, 8, 2, 32)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    want = fa_jax(jq, jk, jv, causal=True, window=window, block_q=8,
                  block_k=8, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    plain = FA.flash_attention_plain(tq, tk, tv, causal=True, window=window)
    assert got.dtype == plain.dtype == getattr(torch, dtype)
    assert str(want.dtype) == dtype
    want = np.asarray(want, np.float32)
    diff = np.abs(got.float().numpy() - want).max()
    assert diff <= _step(want, dtype), diff


def test_build_targets_sm90a_per_source():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    srcs = build.sources()
    assert [s.name for s in srcs] == ["decode_attention.cu",
                                      "flash_attention.cu", "quantized.cu",
                                      "rwkv6.cu"]
    assert len({build._target(s) for s in srcs}) == 4
    assert all(build._target(s).parent == build.BUILD_DIR for s in srcs)
    text = srcs[1].read_text()
    assert "repro/kernels/flash_attention.py::flash_attention" in text
    assert 'extern "C" int repro_flash_attention_fwd' in text
    text = srcs[2].read_text()
    for fn in ("quantize_rowwise", "dequantize_rowwise", "int8_matmul"):
        assert f'extern "C" int repro_{fn}' in text


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_kernel_matches_plain_on_card(dtype):
    """Runs only where a CUDA card is present: bf16/fp16 causal GQA at
    D=128 (the LLM zoo's prefill) and a kv_lengths batch with a zero row,
    kernel against plain within one step of the output's scale in the
    output's type, masked rows exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(a).to(dev, dtype)
               for a in _qkv(11, 1, 200, 200, 8, 2, 128))
    got = ops.flash_attention(q, k, v, causal=True, window=64)
    want = FA.flash_attention_plain(q, k, v, causal=True, window=64)
    name = str(dtype).split(".")[-1]
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= \
        _step(want.float().cpu(), name)
    q, k, v = (torch.from_numpy(a).to(dev, dtype)
               for a in _qkv(12, 3, 64, 64, 12, 12, 26))
    lens = torch.tensor([64, 17, 0], dtype=torch.int32, device=dev)
    got = ops.flash_attention(q, k, v, causal=False, kv_lengths=lens)
    want = FA.flash_attention_plain(q, k, v, causal=False, kv_lengths=lens)
    assert float((got.float() - want.float()).abs().max()) <= \
        _step(want.float().cpu(), name)
    assert float(got[2].abs().max()) == 0.0


def test_kv_lengths_at_head_dim_64():
    """BERT-base's head dim, a B=2, S=128 batch with one short row."""
    q, k, v = _qkv(10, 2, 128, 128, 4, 4, 64)
    lens = np.array([128, 37], np.int32)
    want, got = _both(q, k, v, block=32, causal=False, kv_lengths=lens)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_segments_at_head_dim_64():
    """The packed ragged layout at head dim 64: rows at 8-aligned offsets,
    -1 gaps, an interior -1 and a ragged tail."""
    S = 45
    seg = np.full((1, S), -1, np.int32)
    seg[0, 0:13], seg[0, 16:30], seg[0, 32:43] = 0, 1, 2
    seg[0, 20] = -1
    q, k, v = _qkv(11, 1, S, S, 2, 2, 64)
    want, got = _both(q, k, v, causal=False, segment_ids=seg)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(got[seg == -1]).max() == 0.0


@pytest.mark.parametrize("shape, plan", [
    ((1, 64, 64, 12, 26), (16, 32)),     # TinyBERT per event
    ((1, 64, 64, 12, 64), (16, 64)),     # BERT-base per event
    ((1, 64, 64, 4, 32), (16, 32)),      # MobileBERT per event
    ((8, 128, 128, 12, 64), (128, 64)),  # BERT-base, B=8 S=128
    ((64, 64, 64, 12, 26), (64, 32)),    # TinyBERT padded batch
    ((1, 512, 512, 12, 26), (16, 32)),   # the S=512 segments buffer
    ((8, 128, 128, 12, 128), (64, 128)),  # no 128-row tile at head dim 128
    ((64, 32, 32, 12, 26), (16, 32)),    # short rows: no block S fills
])
def test_plan_tiles_at_path_shapes(shape, plan):
    assert FA.plan_tiles(*shape) == plan
    B, Sq, _, H, _ = shape
    block_q, _ = plan
    assert block_q in FA.BLOCK_Q
    assert block_q <= Sq or block_q == min(FA.BLOCK_Q)
    if B * H * -(-Sq // 16) <= FA.SMALL_GRID_WAVES * build.SMS:
        assert block_q == 16


def test_plan_tiles_and_launch_refuse_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="head dim 130"):
        FA.plan_tiles(1, 8, 8, 2, 130)
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="block_q=32"):
        FA._launch(q, q, q, causal=False, window=0, scale=1.0,
                   kv_lengths=None, segment_ids=None, block_q=32)


@pytest.mark.parametrize("source, replaces", [
    ("flash_attention.cu", "repro/kernels/flash_attention.py::flash_attention"),
    ("rwkv6.cu", "repro/kernels/rwkv6.py::rwkv6_scan"),
])
def test_source_note_names_kernel_bound_and_design(source, replaces):
    """Each redesigned kernel's note says which TPU kernel it replaces,
    what bounds it on the card and what its design does about that."""
    note = (build.CSRC / source).read_text().split("#include")[0]
    assert replaces in note
    assert "What bounds it on this card" in note
    assert "What the design does about that" in note


@pytest.mark.parametrize("shape, dtype, plan", [
    ((1, 512, 512, 32, 128), torch.bfloat16, (64, 128)),  # Mistral prefill
    ((1, 512, 512, 16, 128), torch.bfloat16, (64, 128)),  # OLMoE prefill
    ((1, 512, 512, 16, 128), torch.float16, (64, 128)),
    ((2, 64, 64, 12, 26), torch.bfloat16, (64, 32)),      # D=26 views
    ((8, 2048, 2048, 32, 128), torch.bfloat16, (64, 128)),  # many waves
])
def test_half_plan_at_llm_shapes(shape, dtype, plan):
    """bf16 and fp16 take the tensor-core kernel's plan, 64 rows on 4
    warps at every shape; the float32 plan of the same shape is its own."""
    assert FA.plan_tiles(*shape, dtype=dtype) == plan
    assert plan[0] in FA.HALF_BLOCK_Q
    assert FA.plan_tiles(*shape) == FA.plan_tiles(*shape, dtype=torch.float32)


def test_cuda_launch_refuses_float32_plans_for_half_types():
    """A bf16 call takes only the tensor-core kernel's row counts, before
    any build or launch; float32 keeps its own."""
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_q=16"):
        FA._launch(q, q, q, causal=False, window=0, scale=1.0,
                   kv_lengths=None, segment_ids=None, block_q=16)


def _mma_emulation(q, k, v, *, causal=True, window=0, kv_lengths=None,
                   split=True, block_k=64):
    """The tensor-core kernel's rounding points in torch: q, k, v in their
    half type (exact in float32), S in float32 over 64-key tiles, the
    online softmax in float32, P rounded to the input type as P_hi + P_lo
    (or once, ``split=False``), P V summed in float32, the output rounded
    to the input type once."""
    dtype = q.dtype
    B, Sq, H, D = q.shape
    _, Sk, KV, Dv = v.shape
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, D)
    kf, vf = k.float(), v.float()
    mask = FA.attention_mask(B, Sq, Sk, causal=causal, window=window,
                             kv_lengths=kv_lengths)[:, None, None]
    m = torch.full((B, KV, G, Sq), FA.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, Sq, Dv))
    for t0 in range(0, Sk, block_k):
        mk = mask[..., t0:t0 + block_k]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, t0:t0 + block_k])
        s = torch.where(mk, s / math.sqrt(D), torch.tensor(FA.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mk, torch.exp(s - m_new[..., None]), torch.tensor(0.0))
        l = l * corr + p.sum(-1)
        p_hi = p.to(dtype).float()
        parts = [p_hi, (p - p_hi).to(dtype).float()] if split else [p_hi]
        pv = sum(torch.einsum("bhgqk,bkhd->bhgqd", x, vf[:, t0:t0 + block_k])
                 for x in parts)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", ["causal_gqa_d128", "window", "lengths"])
def test_mma_rounding_points_match_pallas(case, dtype):
    """The CUDA half-type kernel's arithmetic, emulated in torch, within
    one step of its type at the output's scale of the Pallas kernel in
    interpret mode on the same inputs: causal GQA at D=128 (Sk past one
    64-key tile), a window, and kv_lengths with a zero-length row, which
    stays exactly 0."""
    kw = {"causal_gqa_d128": dict(shape=(1, 80, 80, 4, 2, 128), causal=True),
          "window": dict(shape=(1, 96, 96, 4, 1, 64), causal=True, window=24),
          "lengths": dict(shape=(3, 40, 72, 2, 2, 128), causal=False,
                          kv_lengths=np.array([72, 17, 0], np.int32))}[case]
    shape = kw.pop("shape")
    q, k, v = _qkv(20, *shape)
    jkw = {k_: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for k_, a in kw.items()}
    want = fa_jax(*(jnp.asarray(a, dtype) for a in (q, k, v)), block_q=8,
                  block_k=8, interpret=True, **jkw)
    want = np.asarray(want, np.float32)
    tkw = {k_: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for k_, a in kw.items()}
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = _mma_emulation(tq, tk, tv, **tkw)
    assert got.dtype == getattr(torch, dtype)
    diff = np.abs(got.float().numpy() - want).max()
    assert diff <= _step(want, dtype), diff
    if case == "lengths":
        assert float(got[2].float().abs().max()) == 0.0


def test_p_split_keeps_mistral_prefill_inside_one_step():
    """Why the kernel splits P: at Mistral's prefill shape (S=512, H=32,
    KV=8, D=128, causal, seed 9) rounding P once to bf16 puts the output a
    whole bf16 step of its scale from the float32 result, the tolerance
    itself; P_hi + P_lo leaves a quarter of a step."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn((1, 512, 32, 128), generator=g).bfloat16()
    k = torch.randn((1, 512, 8, 128), generator=g).bfloat16()
    v = torch.randn((1, 512, 8, 128), generator=g).bfloat16()
    exact = FA.flash_attention_plain(q.float(), k.float(), v.float())
    step = _step(exact.bfloat16().float().numpy(), "bfloat16")
    rounded = exact.bfloat16().float()
    steps = {split: float((_mma_emulation(q, k, v, split=split).float()
                           - rounded).abs().max()) / step
             for split in (False, True)}
    assert steps[True] <= 0.25 < 0.75 <= steps[False] <= 1.0, steps
