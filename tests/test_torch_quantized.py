"""The port's int8 kernels and sidecar against the JAX reference, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages. The
JAX side runs its Pallas kernels with ``interpret=True``, as
``tests/test_quantized.py`` does; the port's wrappers take their plain
versions on CPU tensors. Tolerances, and why:

  * ``quantize_rowwise``: the port's scale is ``max|x| / 127`` as an IEEE
    division; XLA may turn the Pallas kernel's ``/ 127`` into a multiply
    by the reciprocal, so the JAX scale may sit one ulp away (the
    reference's own test allows it). q is compared exactly on rows whose
    two scales are bit-equal and within one level elsewhere; scales at
    rtol 1e-6. Against the jnp oracle ``ref.quantize_rowwise_ref`` both
    are exact.
  * ``int8_matmul`` / ``dequantize_rowwise`` on identical int8 inputs:
    exact (integer accumulation, then the same float32 products).
  * ``quantized_matmul`` against the float32 GEMM: the analytic bound of
    ``tests/test_quantized.py``.
  * encoders over the int8 sidecar: 1e-4 absolute against JAX's sidecar
    encoders (measured 2.4e-7 on the microbert text encoder at seed 0;
    a one-level flip of one activation, which a one-ulp scale
    difference can cause, moves a feature by about
    max|x|/127 * max|w_q * w_scale|, a few 1e-4 at these widths).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.emsnet import tiny as jax_tiny
from repro.core import emsnet_zoo as jax_zoo
from repro.core import split as jax_split
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.models import quantized as JQ
from repro_torch.configs.emsnet import tiny
from repro_torch.convert import from_jax_numpy
from repro_torch.core import emsnet_zoo, split
from repro_torch.kernels import ops as PO
from repro_torch.kernels import quantized as PK
from repro_torch.models import quantized as PQ

TEXT = "microbert"
GEMM_SHAPES = [(8, 32, 16), (32, 64, 128), (33, 100, 130), (1, 7, 5),
               (64, 128, 256)]
MAIN_PATH_GEMMS = [(64, 64, 192), (64, 64, 64), (64, 64, 128),
                   (64, 128, 64), (5, 6, 48), (1, 3, 8)]
ENC_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _jq(x):
    q, s = JO.quantize_rowwise(jnp.asarray(x), interpret=True)
    return np.asarray(q), np.asarray(s)


def _assert_q_matches(qp, sp, qj, sj):
    """Exact where the scales are bit-equal, one level elsewhere."""
    qp, sp = qp.numpy(), sp.numpy()
    np.testing.assert_allclose(sp, sj, rtol=1e-6)
    same = (sp == sj).ravel()
    np.testing.assert_array_equal(qp[same], qj[same])
    assert np.abs(qp.astype(int) - qj.astype(int)).max(initial=0) <= 1


# ------------------------------------------------------------- kernels

@pytest.mark.parametrize("shape", [(M, K) for M, K, _ in GEMM_SHAPES]
                         + [(64, 1200), (30, 6), (1, 3)])
def test_quantize_rowwise_matches_jax(shape):
    x = (np.random.default_rng(sum(shape)).normal(size=shape) * 2.0) \
        .astype(np.float32)
    qp, sp = PO.quantize_rowwise(_t(x))
    assert qp.dtype == torch.int8 and tuple(sp.shape) == (shape[0], 1)
    _assert_q_matches(qp, sp, *_jq(x))
    qr, sr = JR.quantize_rowwise_ref(jnp.asarray(x))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sr))


def test_quantize_zero_row_and_half_ties():
    """A row whose max is 127 has scale exactly 1.0, so x.5 entries are
    ties: they round half to even, as jnp.round does."""
    x = np.zeros((3, 8), np.float32)
    x[1] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5]
    qp, sp = PO.quantize_rowwise(_t(x))
    assert sp[:, 0].tolist() == [1.0, 1.0, 1.0]
    assert qp[1].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]
    assert qp[0].abs().max() == 0 and qp[2].abs().max() == 0
    qj, sj = _jq(x)
    np.testing.assert_array_equal(qp.numpy(), qj)
    np.testing.assert_array_equal(sp.numpy(), sj)


def _layout(name, rng):
    """(the float32 view the port quantizes, the same values contiguous
    for JAX) for each layout the CUDA kernel's plan tells apart."""
    if name == "offset_64x312":        # rows off 16 bytes
        full = _t(rng.normal(size=(64, 313)).astype(np.float32) * 2.0)
        x = full[:, 1:]
    elif name == "rows_2x2048":        # a block a row, at the rows form's cap
        x = _t(rng.normal(size=(2, 2048)).astype(np.float32) * 2.0)
    elif name == "loop_8x4100":        # over the rows form's cap
        x = _t(rng.normal(size=(8, 4100)).astype(np.float32) * 2.0)
    elif name == "colwise_1200x312":   # the view w.T of the sidecar's w2
        x = _t(rng.normal(size=(1200, 312)).astype(np.float32)).T
    else:                              # strided_40x100: neither rows nor cols
        x = _t(rng.normal(size=(40, 200)).astype(np.float32))[:, ::2]
    return x, np.ascontiguousarray(x.numpy())


LAYOUT_NAMES = ["offset_64x312", "rows_2x2048", "loop_8x4100",
                "colwise_1200x312", "strided_40x100"]


@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_quantize_layouts_match_jax(name):
    x, xc = _layout(name, np.random.default_rng(len(name)))
    assert not x.is_contiguous() or name.startswith(("rows", "loop"))
    qp, sp = PO.quantize_rowwise(x)
    assert tuple(qp.shape) == tuple(x.shape) and tuple(sp.shape) == (x.shape[0], 1)
    _assert_q_matches(qp, sp, *_jq(xc))
    qr, sr = JR.quantize_rowwise_ref(jnp.asarray(xc))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sr))


def test_quantize_zero_rows_and_ties_at_the_w2_width():
    """All-zero rows (scale 1.0, q 0) among rows of .5 ties at K = 1200,
    row-major and as a transposed view."""
    x = np.zeros((6, 1200), np.float32)
    tie = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5], np.float32)
    x[1], x[3] = np.tile(tie, 150), -np.tile(tie, 150)
    x[4] = np.random.default_rng(4).normal(size=1200)
    qj, sj = _jq(x)
    for view in (_t(x), _t(np.ascontiguousarray(x.T)).T):
        qp, sp = PO.quantize_rowwise(view)
        np.testing.assert_array_equal(qp.numpy(), qj)
        np.testing.assert_array_equal(sp.numpy(), sj)
        assert qp[1, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]
        assert sp[[0, 1, 2, 3, 5], 0].tolist() == [1.0] * 5
        assert qp[[0, 2, 5]].abs().max() == 0


@pytest.mark.parametrize("shape", [(4, 16), (33, 100), (1, 7), (32, 128)])
def test_quantize_roundtrip_within_half_scale(shape):
    x = (np.random.default_rng(7).normal(size=shape) * 3.0).astype(np.float32)
    q, s = PO.quantize_rowwise(_t(x))
    back = PO.dequantize_rowwise(q, s).numpy()
    assert (np.abs(back - x) <= s.numpy() / 2.0 + 1e-7).all()


@pytest.mark.parametrize("shape", GEMM_SHAPES + MAIN_PATH_GEMMS)
def test_int8_matmul_exact_vs_jax(shape):
    M, K, N = shape
    rng = np.random.default_rng(M * 7 + K)
    xq, sx = JR.quantize_rowwise_ref(jnp.asarray(rng.normal(size=(M, K)),
                                                 jnp.float32))
    wq, sw = JR.quantize_rowwise_ref(jnp.asarray(rng.normal(size=(N, K)),
                                                 jnp.float32))
    wq, sw = wq.T, sw.T
    want = np.asarray(JO.int8_matmul(xq, sx, wq, sw, interpret=True))
    got = PO.int8_matmul(*(_t(np.asarray(a)) for a in (xq, sx, wq, sw)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JR.int8_matmul_ref(xq, sx, wq, sw)))


def test_int8_matmul_exact_past_float32_integers():
    """K = 1200 of +-127 products passes 2^24: the int32 accumulator is
    exact and converted to float32 once, with round to nearest."""
    K = 1200
    xq = np.full((2, K), 127, np.int8)
    xq[1, ::2] = -127
    wq = np.full((K, 3), 127, np.int8)
    wq[:, 1] = -127
    wq[1::3, 2] = 1
    sx, sw = np.ones((2, 1), np.float32), np.ones((1, 3), np.float32)
    got = PO.int8_matmul(_t(xq), _t(sx), _t(wq), _t(sw)).numpy()
    acc = xq.astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(acc).max() > 2 ** 24
    np.testing.assert_array_equal(got, acc.astype(np.float32))
    np.testing.assert_array_equal(got, np.asarray(JO.int8_matmul(
        jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(wq), jnp.asarray(sw),
        interpret=True)))


@pytest.mark.parametrize("d", [312, 64, 16])
def test_dequantize_rowwise_exact_vs_jax(d):
    rng = np.random.default_rng(d)
    q = rng.integers(-127, 128, (1, d)).astype(np.int8)
    s = np.abs(rng.normal(size=(1, 1))).astype(np.float32)
    want = np.asarray(JO.dequantize_rowwise(jnp.asarray(q), jnp.asarray(s),
                                            interpret=True))
    np.testing.assert_array_equal(PO.dequantize_rowwise(_t(q), _t(s)).numpy(),
                                  want)


@pytest.mark.parametrize("shape", [(5, 7), (64, 1200), (2, 4100)])
def test_dequantize_shapes_exact_vs_jax(shape):
    """Rows whose length is not a multiple of 4, the w2 input's width, a
    row longer than the rows quantize form's cap."""
    rng = np.random.default_rng(sum(shape))
    q = rng.integers(-127, 128, shape).astype(np.int8)
    s = np.abs(rng.normal(size=(shape[0], 1))).astype(np.float32)
    want = np.asarray(JO.dequantize_rowwise(jnp.asarray(q), jnp.asarray(s),
                                            interpret=True))
    np.testing.assert_array_equal(PO.dequantize_rowwise(_t(q), _t(s)).numpy(),
                                  want)


@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_quantized_matmul_within_analytic_bound(shape):
    M, K, N = shape
    rng = np.random.default_rng(K)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    wq, sw = PO.quantize_colwise(_t(w))
    assert wq.is_contiguous() and tuple(wq.shape) == (K, N)
    assert tuple(sw.shape) == (1, N)
    got = PO.quantized_matmul(_t(x), wq, sw).numpy()
    _, sx = PO.quantize_rowwise(_t(x))
    w_hat = wq.numpy().astype(np.float32) * sw.numpy()
    bound = (sw.numpy() / 2.0 * np.abs(x).sum(1, keepdims=True)
             + sx.numpy() / 2.0 * np.abs(w_hat).sum(0, keepdims=True))
    assert (np.abs(got - x @ w) <= bound + 1e-5).all()
    jq, js = JO.quantize_colwise(jnp.asarray(w), interpret=True)
    _assert_q_matches(wq.T.contiguous(), sw.T.contiguous(),
                      np.asarray(jq).T, np.asarray(js).T)


def test_quantized_matmul_leading_dims():
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(2, 5, 32)).astype(np.float32))
    wq, sw = PO.quantize_colwise(_t((rng.normal(size=(32, 16)) / 6)
                                    .astype(np.float32)))
    got = PO.quantized_matmul(x, wq, sw)
    assert tuple(got.shape) == (2, 5, 16)
    assert torch.equal(got.reshape(10, 16),
                       PO.quantized_matmul(x.reshape(10, 32), wq, sw))


def test_int8_matmul_k_guard_and_shape_checks():
    K = PK.MAX_K + 1
    with pytest.raises(ValueError, match="int32 accumulator"):
        PO.int8_matmul(torch.zeros((1, K), dtype=torch.int8),
                       torch.ones((1, 1)), torch.zeros((K, 4),
                                                       dtype=torch.int8),
                       torch.ones((1, 4)))
    with pytest.raises(ValueError, match="contraction mismatch"):
        PO.int8_matmul(torch.zeros((2, 3), dtype=torch.int8),
                       torch.ones((2, 1)), torch.zeros((4, 5),
                                                       dtype=torch.int8),
                       torch.ones((1, 5)))
    assert PK.MAX_K == (1 << 31) // (127 * 127)


def test_cpu_tensors_count_calls_but_launch_nothing():
    fns = (PK.quantize_rowwise, PK.dequantize_rowwise, PK.int8_matmul)
    before = [(f.calls, f.launches) for f in fns]
    q, s = PO.quantize_rowwise(torch.ones((4, 6)))
    PO.dequantize_rowwise(q, s)
    PO.int8_matmul(q, s, q.T.contiguous(), torch.ones((1, 4)))
    after = [(f.calls, f.launches) for f in fns]
    assert [a[0] - b[0] for a, b in zip(after, before)] == [1, 1, 1]
    assert [a[1] - b[1] for a, b in zip(after, before)] == [0, 0, 0]


def test_zero_rows_launch_nothing():
    q, s = PO.quantize_rowwise(torch.zeros((0, 5)))
    assert tuple(q.shape) == (0, 5) and tuple(s.shape) == (0, 1)
    out = PO.int8_matmul(q, s, torch.zeros((5, 3), dtype=torch.int8),
                         torch.ones((1, 3)))
    assert tuple(out.shape) == (0, 3)


@pytest.mark.parametrize("M, K, N", MAIN_PATH_GEMMS + GEMM_SHAPES + [
    (64, 1200, 312), (64, 312, 936), (64, 312, 1200), (30, 6, 192),
    (1, 3, 16), (130, 312, 312), (64, 32, 8), (2, 4000, 3), (64, 1216, 64),
    (256, 129, 640)])
def test_k_split_plan_covers_k(M, K, N):
    """K chunks are multiples of K_STEP except the last, cover [0, K) in
    order, none empty, and their count stays within the cluster cap."""
    ksplit, kchunk = PK.plan_k_splits(M, K, N)
    assert 1 <= ksplit <= PK.MAX_KSPLIT
    assert kchunk % PK.K_STEP == 0
    spans = [(i * kchunk, min(K, (i + 1) * kchunk)) for i in range(ksplit)]
    assert spans[0][0] == 0 and spans[-1][1] == K
    assert all(a < b for a, b in spans)
    assert all((b - a) % PK.K_STEP == 0 for a, b in spans[:-1])


def test_k_split_plan_at_the_text_layer():
    # 5 N tiles x 8 chunks of 160 at K = 1200; 15 x 5 chunks of 64 at 312
    assert PK.plan_k_splits(64, 1200, 312) == (8, 160)
    assert PK.plan_k_splits(64, 312, 936) == (5, 64)
    assert PK.plan_k_splits(30, 6, 192) == (1, 32)


def _quantize_coverage(plan, M, K):
    """How many times the CUDA quantize kernel that ``plan`` launches
    writes each q element (csrc/quantized.cu's index arithmetic, in
    numpy), after the C entry point's own checks of the plan."""
    hits = np.zeros((M, K), np.int64)
    if plan.form == "cols":
        ksplit, warps = plan.grid[1], plan.warps
        assert plan.grid[0] == -(-M // 32) and 1 <= ksplit <= PK.MAX_KSPLIT
        assert plan.kchunk % 4 == 0 and plan.kchunk <= PK.COL_TILE
        assert plan.kchunk <= warps * plan.depth <= PK.COL_TILE
        assert plan.depth in PK.COL_DEPTHS
        for g in range(plan.grid[0]):
            for z in range(ksplit):
                kb = z * plan.kchunk
                n = min(K, kb + plan.kchunk) - kb
                assert n > 0                      # no split is empty
                for w in range(warps):
                    kk = w + warps * np.arange(plan.depth)
                    kk = kk[kk < n]
                    for m in range(32 * g, min(M, 32 * g + 32)):
                        hits[m, kb + kk] += 1
        return hits
    tpr, rows = plan.tpr, 32 * plan.warps // plan.tpr
    assert tpr % 32 == 0 and rows * tpr == 32 * plan.warps
    assert plan.warps <= PK.MAX_WARPS and plan.grid[1] == 1
    assert plan.grid[0] * rows >= M > (plan.grid[0] - 1) * rows
    if plan.form == "loop":
        hits[:] = 1                   # a strided loop over k < K
        return hits
    assert 1 <= plan.depth <= PK.ROWS_VECS
    for t in range(tpr):
        k = (4 * (tpr * np.arange(plan.depth) + t)[:, None]
             + np.arange(4)).ravel()
        hits[:, k[k < K]] += 1
    return hits


LAYOUTS = [  # (M, K, x_sm, x_sk, aligned): the path's views, then edges
    (64, 312, 312, 1, True), (64, 1200, 1200, 1, True), (30, 6, 6, 1, False),
    (1, 3, 3, 1, True), (1, 312, 312, 1, True), (1, 64, 64, 1, True),
    (1, 16, 16, 1, True), (33, 100, 100, 1, True),
    (936, 312, 1, 936, False), (312, 312, 1, 312, False),
    (1200, 312, 1, 1200, False), (312, 1200, 1, 312, False),
    (192, 6, 1, 192, False), (16, 3, 1, 16, False),
    (64, 312, 313, 1, False), (8, 4100, 4100, 1, True),
    (2, 13000, 13000, 1, True), (2, 2048, 2048, 1, True),
    (40, 4000, 1, 40, False), (130, 312, 312, 1, True),
    (1000, 64, 64, 1, True), (40, 100, 200, 2, False), (6, 1200, 1, 6, False),
    (5, 7, 1, 5, False), (312, 2000, 1, 312, False), (3, 1, 7, 5, False)]


@pytest.mark.parametrize("M, K, x_sm, x_sk, aligned", LAYOUTS)
def test_quantize_plan_writes_every_element_once(M, K, x_sm, x_sk, aligned):
    plan = PK.plan_quantize(M, K, x_sm, x_sk, aligned)
    assert plan.form in PK.QUANTIZE_FORMS
    if plan.form == "rows":
        assert aligned
    if plan.form.startswith("rows"):
        assert x_sk == 1 or K <= 1
    if plan.form == "cols":
        assert x_sm == 1
    assert (_quantize_coverage(plan, M, K) == 1).all()


PLANS = {  # the plan at each of the path's layouts, and at the edges
    (64, 312, 312, 1, True): ('rows', 1, 3, 96, (64, 1), 0),
    (64, 1200, 1200, 1, True): ('rows', 2, 8, 256, (64, 1), 0),
    (1, 312, 312, 1, True): ('rows', 1, 3, 96, (1, 1), 0),
    (33, 100, 100, 1, True): ('rows', 1, 1, 32, (33, 1), 0),
    (30, 6, 6, 1, False): ('rows_scalar', 1, 1, 32, (30, 1), 0),
    (64, 312, 313, 1, False): ('rows_scalar', 1, 3, 96, (64, 1), 0),
    (936, 312, 1, 936, False): ('cols', 8, 16, 0, (30, 4), 80),
    (312, 312, 1, 312, False): ('cols', 4, 16, 0, (10, 5), 64),
    (1200, 312, 1, 1200, False): ('cols', 8, 16, 0, (38, 3), 104),
    (312, 1200, 1, 312, False): ('cols', 12, 16, 0, (10, 8), 152),
    (192, 6, 1, 192, False): ('cols', 1, 16, 0, (6, 1), 8),
    (16, 3, 1, 16, False): ('cols', 1, 16, 0, (1, 1), 4),
    (2, 2048, 2048, 1, True): ('rows', 2, 8, 256, (2, 1), 0),
    (8, 4100, 4100, 1, True): ('loop', 0, 5, 160, (8, 1), 0),
    (2, 13000, 13000, 1, True): ('loop', 0, 8, 256, (2, 1), 0),
    (40, 4000, 1, 40, False): ('loop', 0, 4, 128, (40, 1), 0),
    (40, 100, 200, 2, False): ('loop', 0, 1, 32, (40, 1), 0),
}


@pytest.mark.parametrize("layout", list(PLANS))
def test_quantize_plan_at_the_path(layout):
    plan = PK.plan_quantize(*layout)
    assert tuple(plan) == PLANS[layout]


@pytest.mark.parametrize("M", [1, 2, 33, 312, 1200, 5000])
def test_quantize_plan_within_the_kernel_limits(M):
    """Every K up to each form's cap plans within what the C entry point
    accepts (it refuses any other plan): the rows form's float4 slots,
    the cols form's tile, warps, depths and a split of K with no empty
    chunk."""
    for K in range(1, PK.ROWS_CAP + 1):
        p = PK.plan_quantize(M, K, K, 1, True)
        assert p.form == "rows" and 1 <= p.depth <= PK.ROWS_VECS
        assert 4 * p.tpr * p.depth >= K and p.warps <= PK.MAX_WARPS
    assert PK.plan_quantize(M, PK.ROWS_CAP + 1, PK.ROWS_CAP + 1, 1,
                            True).form == "loop"
    if M == 1:
        return
    for K in range(2, PK.COLS_CAP + 1):
        p = PK.plan_quantize(M, K, 1, M, False)
        ksplit = p.grid[1]
        assert p.form == "cols" and p.depth in PK.COL_DEPTHS
        assert p.warps <= PK.COL_MAX_WARPS and 1 <= ksplit <= PK.MAX_KSPLIT
        assert p.kchunk % 4 == 0 and p.kchunk <= min(PK.COL_TILE,
                                                     p.warps * p.depth)
        assert ksplit * p.kchunk >= K > (ksplit - 1) * p.kchunk
    assert PK.plan_quantize(M, PK.COLS_CAP + 1, 1, M, False).form == "loop"


def test_kernels_match_plain_versions_on_the_card():
    """Card-only: each CUDA kernel is bit-equal to its plain version at a
    shape with K and N tails (``python3 chip_smoke.py`` runs every main
    path shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(33, 100)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.normal(size=(100, 130)).astype(np.float32)).cuda()
    q, s = PO.quantize_rowwise(x)
    qr, sr = PK.quantize_rowwise_plain(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    wq, sw = PO.quantize_colwise(w)
    assert torch.equal(PO.int8_matmul(q, s, wq, sw),
                       PK.int8_matmul_plain(q, s, wq, sw))
    assert torch.equal(PO.dequantize_rowwise(q, s),
                       PK.dequantize_rowwise_plain(q, s))
    # chip_smoke.py's tensor-core tile edges and the +-127 extremes
    for M, K, N in ((130, 312, 312), (64, 32, 8), (64, 1200, 312)):
        q, s = PO.quantize_rowwise(torch.from_numpy(
            rng.normal(size=(M, K)).astype(np.float32)).cuda())
        wq, sw = PO.quantize_colwise(torch.from_numpy(
            rng.normal(size=(K, N)).astype(np.float32)).cuda())
        assert torch.equal(PO.int8_matmul(q, s, wq, sw),
                           PK.int8_matmul_plain(q, s, wq, sw)), (M, K, N)
    q = torch.from_numpy(rng.choice([-127, 127], size=(64, 1200))
                         .astype(np.int8)).cuda()
    wq = torch.from_numpy(rng.choice([-127, 127], size=(1200, 312))
                          .astype(np.int8)).cuda()
    s, sw = torch.ones((64, 1)).cuda(), torch.ones((1, 312)).cuda()
    assert torch.equal(PO.int8_matmul(q, s, wq, sw),
                       PK.int8_matmul_plain(q, s, wq, sw))
    # every form of the quantize kernel's plan
    for name in LAYOUT_NAMES:
        x = _layout(name, rng)[0].cuda()
        got, want = PO.quantize_rowwise(x), PK.quantize_rowwise_plain(x)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
    # dequantize: K % 4 != 0, the w2 input's width, a long row
    for M, K in ((64, 1200), (5, 7), (2, 4100)):
        q, s = PK.quantize_rowwise_plain(torch.from_numpy(
            rng.normal(size=(M, K)).astype(np.float32)).cuda())
        assert torch.equal(PO.dequantize_rowwise(q, s),
                           PK.dequantize_rowwise_plain(q, s)), (M, K)


# ------------------------------------------------------------- sidecar

@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jax_tiny(text_encoder=TEXT), tiny(text_encoder=TEXT)
    jzoo = jax_zoo(jcfg)
    jsm = jax_split(jzoo["text+vitals+scene"])
    jshared = jzoo["text+vitals+scene"].init_fn(jax.random.PRNGKey(0))
    psm = split(emsnet_zoo(cfg)["text+vitals+scene"])
    pshared = from_jax_numpy(jax.device_get(jshared), "cpu")
    rng = np.random.default_rng(0)
    payloads = {
        "text": rng.integers(1, cfg.vocab_size, (1, 11)).astype(np.int32),
        "vitals": rng.normal(size=(1, 5, cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }
    return jsm, jshared, psm, pshared, payloads


def test_sidecar_shares_fp32_leaves_by_identity(models):
    _, _, psm, shared, _ = models
    qp = psm.quantize_params(shared)
    assert qp["heads"] is shared["heads"]
    assert qp["text"]["tok"] is shared["text"]["tok"]
    assert qp["text"]["pos"] is shared["text"]["pos"]
    blk, src = qp["text"]["blocks"][0], shared["text"]["blocks"][0]
    assert blk["ln1"] is src["ln1"] and blk["ln2"] is src["ln2"]
    assert qp["vitals"]["wh"] is shared["vitals"]["wh"]
    for k in ("wqkv", "wo", "w1", "w2"):
        assert set(blk[k]) == {"w_q", "w_scale", "b"}
        assert blk[k]["b"] is src[k]["b"]
        assert blk[k]["w_q"].dtype == torch.int8
        assert blk[k]["w_q"].is_contiguous()
    assert qp["vitals"]["wx"]["w_q"].dtype == torch.int8
    assert qp["scene"]["fc"]["b"] is shared["scene"]["fc"]["b"]


def test_sidecar_matches_jax_sidecar(models):
    """Same converted weights: w_q equal where the scales agree (one level
    elsewhere), w_scale within one ulp."""
    _, jshared, psm, shared, _ = models
    jq = jax.device_get(JQ.quantize_emsnet_params(jshared))
    pq = psm.quantize_params(shared)
    pairs = [(jq["vitals"]["wx"], pq["vitals"]["wx"]),
             (jq["scene"]["fc"], pq["scene"]["fc"])]
    for jb, pb in zip(jq["text"]["blocks"], pq["text"]["blocks"]):
        pairs += [(jb[k], pb[k]) for k in ("wqkv", "wo", "w1", "w2")]
    for j, p in pairs:
        sj, sp = np.asarray(j["w_scale"]), p["w_scale"].numpy()
        assert (np.abs(sp.view(np.int32) - sj.view(np.int32)) <= 1).all()
        _assert_q_matches(p["w_q"].T.contiguous(), p["w_scale"].T.contiguous(),
                          np.asarray(j["w_q"]).T, sj.T)
    # the JAX sidecar converted as it is: int8 leaves stay int8
    conv = from_jax_numpy(jq, "cpu")
    assert conv["scene"]["fc"]["w_q"].dtype == torch.int8


@pytest.mark.parametrize("modality", ["text", "vitals", "scene"])
def test_sidecar_encoders_match_jax(models, modality):
    jsm, jshared, psm, shared, payloads = models
    x = payloads[modality]
    want = np.asarray(jsm.encoders[modality](
        JQ.quantize_emsnet_params(jshared), jnp.asarray(x)))
    got = psm.encoders[modality](psm.quantize_params(shared), _t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ENC_ATOL, rtol=0)
    # and the int8 sidecar tracks float32 within a few percent
    f32 = psm.encoders[modality](shared, _t(x)).numpy()
    assert np.abs(got.numpy() - f32).max() <= 0.08 * np.abs(f32).max()


def test_feature_pack_roundtrip_and_wire_size(models):
    _, _, psm, shared, payloads = models
    for m in ("text", "vitals", "scene"):
        f = psm.encoders[m](shared, _t(payloads[m]))
        pack = PQ.quantize_feature(f)
        assert PQ.is_quantized_feature(pack) and not PQ.is_quantized_feature(f)
        d = f.shape[1]
        assert pack["q"].numel() + 4 * pack["scale"].numel() == d + 4
        back = PQ.dequantize_feature(pack)
        assert (back - f).abs().max() <= pack["scale"].max() / 2 + 1e-7
        assert PQ.dequantize_feature(f) is f
        jpack = JQ.quantize_feature(jnp.asarray(f.numpy()))
        _assert_q_matches(pack["q"], pack["scale"], np.asarray(jpack["q"]),
                          np.asarray(jpack["scale"]))


def test_quantize_params_requires_quantize_fn(models):
    from dataclasses import replace
    _, _, psm, shared, _ = models
    bare = split(replace(psm.module, quantize_fn=None))
    with pytest.raises(ValueError, match="declares no quantize_fn"):
        bare.quantize_params(shared)
