"""The port's roofline arithmetic (``repro_torch.analysis.roofline``)
against the JAX package's ``repro.analysis.roofline``: ``model_flops``,
``analytic_hbm_bytes`` (one pod and two, experts over 'model' or over
'data' x 'model') and ``weighted_collective_bytes`` for every arch of the
registry at every input shape, each side on its own config, to 1e-12
relative; the ``Roofline`` terms and keys; and the H100 constants."""
import pytest

from repro.analysis import roofline as JRL
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro_torch.analysis import roofline as RL
from repro_torch.analysis.hlo_analyzer import COLLECTIVES, Totals
from repro_torch.configs import SHAPES, get_config

RTOL = 1e-12


@pytest.mark.parametrize("shape", sorted(JSHAPES))
@pytest.mark.parametrize("arch", JARCHS)
def test_arithmetic_matches_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    s, js = SHAPES[shape], JSHAPES[shape]
    assert RL.model_flops(cfg, s) == pytest.approx(
        JRL.model_flops(jcfg, js), rel=RTOL)
    for pods in (1, 2):
        for experts_2d in (False, True):
            kw = dict(model_shards=16, data_shards=16, pods=pods,
                      experts_2d=experts_2d)
            assert RL.analytic_hbm_bytes(cfg, s, **kw) == pytest.approx(
                JRL.analytic_hbm_bytes(jcfg, js, **kw), rel=RTOL)
    by_kind = {k: float(i + 1) * 1e9 + len(arch) for i, k in
               enumerate(COLLECTIVES)}
    assert RL.weighted_collective_bytes(by_kind) == pytest.approx(
        JRL.weighted_collective_bytes(by_kind), rel=RTOL)


def test_h100_constants():
    assert RL.PEAK_FLOPS == 989e12        # bf16 dense, H100 SXM datasheet
    assert RL.HBM_BW == 3.35e12           # HBM3
    assert RL.LINK_BW == 50e9             # ConnectX-7 400 Gb/s, one way


@pytest.mark.parametrize("chips", (256, 512))
def test_analyze_terms_and_keys_match_reference(chips):
    """The same counts through both ``Roofline``s: the reference's terms
    scaled by its TPU constants over the port's H100 ones, the same
    bottleneck rule, ratio and keys."""
    cfg, jcfg = get_config("olmoe-1b-7b"), jget_config("olmoe-1b-7b")
    t = Totals(flops=3e14, bytes=5e11)
    t.coll.update({"all-gather": 4e10, "all-reduce": 1e9})
    roof = RL.analyze(t, cfg, SHAPES["train_4k"], chips, experts_2d=True)
    pods = chips // 256
    want = JRL.Roofline(
        flops=t.flops, hbm_bytes=JRL.analytic_hbm_bytes(
            jcfg, JSHAPES["train_4k"], pods=pods, experts_2d=True),
        coll_bytes=JRL.weighted_collective_bytes(t.coll),
        model_flops=JRL.model_flops(jcfg, JSHAPES["train_4k"]), chips=chips,
        hbm_bytes_hlo=t.bytes)
    got, ref = roof.as_dict(), want.as_dict()
    assert set(got) == set(ref)
    for k in ("flops_per_device", "hbm_bytes_per_device",
              "collective_bytes_per_device", "model_flops",
              "useful_flops_ratio", "hbm_bytes_hlo_upper_bound"):
        assert got[k] == pytest.approx(ref[k], rel=RTOL)
    assert got["t_compute_s"] == pytest.approx(
        ref["t_compute_s"] * JRL.PEAK_FLOPS / RL.PEAK_FLOPS, rel=RTOL)
    assert got["t_memory_s"] == pytest.approx(
        ref["t_memory_s"] * JRL.HBM_BW / RL.HBM_BW, rel=RTOL)
    assert got["t_collective_s"] == pytest.approx(
        ref["t_collective_s"] * JRL.LINK_BW / RL.LINK_BW, rel=RTOL)
    terms = {"compute": got["t_compute_s"], "memory": got["t_memory_s"],
             "collective": got["t_collective_s"]}
    assert got["bottleneck"] == max(terms, key=terms.get)


def test_one_card_has_no_shards():
    """``chips=1``: the whole model and batch on one card."""
    cfg = get_config("mistral-nemo-12b")
    roof = RL.analyze(Totals(flops=1e12), cfg, SHAPES["decode_32k"], 1)
    assert roof.hbm_bytes == RL.analytic_hbm_bytes(
        cfg, SHAPES["decode_32k"], model_shards=1, data_shards=1, pods=1)
    assert roof.hbm_bytes > cfg.param_count() * 2
    assert roof.t_collective == 0.0
