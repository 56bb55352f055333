"""The port's data pipeline, losses, optimizers, checkpoints and EMSNet
trainer (PMI included), on the CPU at the tiny config in float32.

The first part mirrors the tests of ``tests/test_data_training.py``
against the port. The second holds the port to the JAX package on the
same inputs:

  * data: ``generate``/``splits``/``loader`` arrays equal, element for
    element (both are the same numpy draws);
  * losses: equal within rtol 1e-6 (float32 reductions in another
    order); top-k hits exactly, ties included;
  * one step's gradients, leaf by leaf, within atol 1e-6 / rtol 1e-4,
    and a 10-step loss curve within rtol 1e-4: float32 matmuls and
    reductions of XLA and of PyTorch round differently, and AdamW
    divides by sqrt(v), which magnifies that on near-zero gradients;
  * ``pmi_init`` and checkpoints: exact (copies, no arithmetic).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import emsnet as JC
from repro.configs import get_emsnet_config as jax_get_emsnet_config
from repro.data import synthetic_nemsis as JD
from repro.models import emsnet as JE
from repro.training import checkpoint as JCKPT
from repro.training import emsnet_trainer as JET
from repro.training import losses as JLS
from repro_torch.configs import get_emsnet_config
from repro_torch.configs.emsnet import tiny
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.data import synthetic_nemsis as D
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import emsnet as E
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import emsnet_trainer as ET
from repro_torch.training import losses as LS
from repro_torch.training import optimizer as OPT
from repro_torch.training import tree as T

ROOT = Path(__file__).resolve().parents[1]
TV = ("text", "vitals")
TVS = ("text", "vitals", "scene")
LOSS_RTOL = 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
CURVE_RTOL = 1e-4


@pytest.fixture(scope="module")
def cfg():
    return tiny()


@pytest.fixture(scope="module")
def d1(cfg):
    return D.generate(cfg, 1200, seed=0)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _jax_params(cfg, modalities, seed=0):
    """The JAX initialiser's weights: (JAX tree, the port's tree)."""
    jp = JE.init_params(JC.tiny(), jax.random.PRNGKey(seed), modalities)
    assert JC.tiny().text_dims == cfg.text_dims
    return jp, from_jax_numpy(jax.device_get(jp), "cpu")


def _same_tree(jtree, ptree, **tol):
    """Leaf for leaf, the port's tree against the reference's."""
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    pflat = {"/".join(map(str, path)): to_numpy(leaf)
             for path, leaf in T.paths(ptree)}
    assert list(jflat) == list(pflat)
    for k in jflat:
        if tol:
            np.testing.assert_allclose(pflat[k], jflat[k], err_msg=k, **tol)
        else:
            np.testing.assert_array_equal(pflat[k], jflat[k], err_msg=k)


# ------------------------------------------------------------------ data

def test_dataset_shapes(cfg, d1):
    assert d1.text.shape == (1200, cfg.max_text_len)
    assert d1.vitals.shape == (1200, cfg.vitals_len, cfg.n_vitals)
    assert d1.scene.shape == (1200, 3)
    assert d1.protocol.max() < cfg.n_protocols
    assert d1.medicine.max() < cfg.n_medicines


def test_vitals_normalized_and_outlier_free(d1):
    v = d1.vitals
    assert np.abs(v).max() < 12.0
    nz = v[np.abs(v) > 0]
    assert abs(float(nz.mean())) < 0.3


def test_vitals_left_padded(d1):
    v = d1.vitals
    has_pad = np.abs(v).sum(-1) == 0
    for i in range(50):
        pad_rows = np.where(has_pad[i])[0]
        real_rows = np.where(~has_pad[i])[0]
        if len(pad_rows) and len(real_rows):
            assert pad_rows.max() < real_rows.min()
            break


def test_quantity_labels_standardized(d1):
    q = d1.quantity
    assert abs(float(q.mean())) < 0.1
    assert 0.8 < float(q.std()) < 1.2


def test_split_ratios(d1):
    tr, va, te = D.splits(d1)
    assert len(tr) == 720 and len(va) == 240 and len(te) == 240
    assert len(tr) + len(va) + len(te) == len(d1)


def test_loader_batches(d1):
    b = next(D.loader(d1, 32, modalities=TV))
    assert b["text"].shape[0] == 32
    assert "scene" not in b
    assert set(b["labels"]) == {"protocol", "medicine", "quantity"}


# ---------------------------------------------------------------- losses

def test_cross_entropy_matches_manual():
    logits = torch.randn((7, 5), generator=_gen())
    labels = torch.tensor([0, 1, 2, 3, 4, 0, 1])
    got = LS.cross_entropy(logits, labels)
    p = torch.log_softmax(logits, dim=-1)
    want = -p[torch.arange(7), labels].mean()
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_topk_accuracy():
    logits = torch.tensor([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1]])
    labels = torch.tensor([1, 2])
    m = LS.topk_accuracy(logits, labels, ks=(1, 3))
    assert float(m["top1"]) == 0.5
    assert float(m["top3"]) == 1.0


def test_pearson_spearman_vs_numpy(rng):
    x = rng.normal(size=200).astype(np.float32)
    y = 0.7 * x + rng.normal(size=200).astype(np.float32) * 0.5
    got_p = float(LS.pearsonr(torch.from_numpy(x), torch.from_numpy(y)))
    assert got_p == pytest.approx(float(np.corrcoef(x, y)[0, 1]), abs=1e-4)
    rx = np.argsort(np.argsort(x)).astype(np.float32)
    ry = np.argsort(np.argsort(y)).astype(np.float32)
    want_s = float(np.corrcoef(rx, ry)[0, 1])
    got_s = float(LS.spearmanr(torch.from_numpy(x), torch.from_numpy(y)))
    assert got_s == pytest.approx(want_s, abs=1e-3)


# ------------------------------------------------------------- optimizer

@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_optimizer_decreases_quadratic(name):
    _, init, update = OPT.make_optimizer(name, lr=0.1, weight_decay=0.0,
                                         grad_clip=100.0, warmup_steps=0,
                                         decay_steps=1000)
    params = {"w": torch.randn((8, 4), generator=_gen())}
    state = init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2)

    l0 = float(loss(params))
    for _ in range(30):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state, _ = update({"w": g}, state, params)
    assert float(loss(params)) < 0.2 * l0


def test_grad_clip():
    clipped, norm = OPT.clip_by_global_norm({"a": torch.full((10,), 100.0)},
                                            1.0)
    assert float(norm) == pytest.approx(100.0 * np.sqrt(10), rel=1e-4)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0,
                                                                   rel=1e-4)


def test_schedule_warmup_and_decay():
    c = OPT.OptConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                      min_lr_ratio=0.1)
    assert float(OPT.schedule(c, 5)) == pytest.approx(0.5)
    assert float(OPT.schedule(c, 10)) == pytest.approx(1.0)
    assert float(OPT.schedule(c, 100)) == pytest.approx(0.1)


# ------------------------------------------------------- EMSNet training

def test_training_reduces_loss(cfg, d1):
    tr, _, _ = D.splits(d1)
    ld = D.loader(tr, 64, modalities=TV)
    _, losses = ET.train(cfg, ld, modalities=TV, steps=60, device="cpu")
    assert np.mean(losses[-10:]) < 0.7 * np.mean(losses[:10])


def test_multimodal_beats_unimodal_vitals(cfg, d1):
    """Paper Table 3 direction: text+vitals >> vitals-only on protocol."""
    tr, _, te = D.splits(d1)
    p2, _ = ET.train(cfg, D.loader(tr, 64, modalities=TV), modalities=TV,
                     steps=120, device="cpu")
    m2 = ET.evaluate(p2, cfg, te, TV)
    pv, _ = ET.train(cfg, D.loader(tr, 64, modalities=("vitals",)),
                     modalities=("vitals",), steps=120, device="cpu")
    mv = ET.evaluate(pv, cfg, te, ("vitals",))
    assert m2["protocol_top1"] > mv["protocol_top1"] + 0.15


def test_pmi_beats_scratch_on_small_d2(cfg, d1):
    """Paper Table 4 direction: PMI fine-tuning > training from scratch
    when the 3-modal dataset is tiny."""
    tr, _, _ = D.splits(d1)
    p2, _ = ET.train(cfg, D.loader(tr, 64, modalities=TV), modalities=TV,
                     steps=120, device="cpu")
    d2 = D.generate(cfg, 300, seed=5, modal3=True)
    tr2, _, te2 = D.splits(d2)
    ld3 = D.loader(tr2, 32)
    p3, _ = ET.pmi_finetune(cfg, p2, ld3, steps=60)
    m_pmi = ET.evaluate(p3, cfg, te2, TVS)
    p3s, _ = ET.train(cfg, ld3, modalities=TVS, steps=60, device="cpu")
    m_scr = ET.evaluate(p3s, cfg, te2, TVS)
    assert m_pmi["protocol_top1"] >= m_scr["protocol_top1"]


def test_pmi_frozen_backbone_is_untouched(cfg, d1):
    tr, _, _ = D.splits(d1)
    p2, _ = ET.train(cfg, D.loader(tr, 32, modalities=TV), modalities=TV,
                     steps=10, device="cpu")
    d2 = D.generate(cfg, 200, seed=5, modal3=True)
    tr2, _, _ = D.splits(d2)
    p3, _ = ET.pmi_finetune(cfg, p2, D.loader(tr2, 16), steps=10)
    for sub in TV:
        for a, b in zip(T.leaves(p2[sub]), T.leaves(p3[sub])):
            assert torch.equal(a, b)
    assert not torch.equal(p2["heads"]["protocol"]["b"],
                           p3["heads"]["protocol"]["b"])


# ------------------------------------------------------------ checkpoint

def test_checkpoint_roundtrip(tmp_path, cfg):
    params = E.init_params(cfg, _gen(), TV, device="cpu")
    path = tmp_path / "ckpt.npz"
    CKPT.save(path, params, metadata={"note": "test"})
    template = T.tree_map(torch.zeros_like, params)
    restored = CKPT.restore(path, template)
    for a, b in zip(T.leaves(params), T.leaves(restored)):
        assert torch.equal(a, b)
    assert CKPT.metadata(path)["note"] == "test"


def test_checkpoint_shape_mismatch_raises(tmp_path):
    CKPT.save(tmp_path / "c.npz", {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        CKPT.restore(tmp_path / "c.npz", {"w": torch.zeros((3, 3))})


# ===================================== parity with the JAX reference

def test_get_emsnet_config_matches_reference():
    kw = dict(text_encoder="bertbase", vitals_encoder="lstm", vocab_size=2048)
    j, p = jax_get_emsnet_config(**kw), get_emsnet_config(**kw)
    jf, pf = dataclasses.asdict(j), dataclasses.asdict(p)
    # Pallas' interpret switch has no counterpart; the serving default
    # of the text attention differs on purpose
    assert set(jf) - set(pf) == {"flash_interpret"} and set(pf) <= set(jf)
    assert {k: v for k, v in pf.items() if k != "use_flash_text"} == \
        {k: jf[k] for k in pf if k != "use_flash_text"}
    assert p.text_dims == j.text_dims and p.feature_dims == j.feature_dims


@pytest.mark.parametrize("modal3", [False, True])
def test_generate_splits_loader_equal_reference(cfg, modal3):
    jd = JD.generate(JC.tiny(), 500, seed=3, modal3=modal3)
    pd = D.generate(cfg, 500, seed=3, modal3=modal3)
    for f in ("text", "vitals", "scene", "protocol", "medicine", "quantity"):
        np.testing.assert_array_equal(getattr(pd, f), getattr(jd, f), f)
        assert getattr(pd, f).dtype == getattr(jd, f).dtype
    for js, ps in zip(JD.splits(jd, seed=2), D.splits(pd, seed=2)):
        np.testing.assert_array_equal(ps.text, js.text)
        np.testing.assert_array_equal(ps.quantity, js.quantity)
    jl = JD.loader(jd, 48, seed=4, modalities=TV)
    pl = D.loader(pd, 48, seed=4, modalities=TV)
    for _ in range(12):                      # past one epoch's reshuffle
        jb, pb = next(jl), next(pl)
        assert set(jb) == set(pb)
        for m in TV:
            np.testing.assert_array_equal(pb[m], jb[m])
        for k in jb["labels"]:
            np.testing.assert_array_equal(pb["labels"][k], jb["labels"][k])


def test_losses_match_reference(rng):
    logits = rng.normal(size=(33, 46)).astype(np.float32) * 3
    labels = rng.integers(0, 46, size=33).astype(np.int32)
    mask = (rng.random(33) < 0.6).astype(np.float32)
    jl, pl = jnp.asarray(logits), torch.from_numpy(logits)
    jy, py = jnp.asarray(labels), torch.from_numpy(labels)
    assert float(LS.cross_entropy(pl, py)) == pytest.approx(
        float(JLS.cross_entropy(jl, jy)), rel=LOSS_RTOL)
    assert float(LS.cross_entropy(pl, py, mask=torch.from_numpy(mask))) == \
        pytest.approx(float(JLS.cross_entropy(jl, jy, mask=jnp.asarray(mask))),
                      rel=LOSS_RTOL)
    # ties: whole rows of equal logits, and equal pairs around the label
    tied = np.round(logits, 0)
    tied[:4] = 1.0
    for arr in (logits, tied):
        jm = JLS.topk_accuracy(jnp.asarray(arr), jy)
        pm = LS.topk_accuracy(torch.from_numpy(arr), py)
        assert {k: float(v) for k, v in pm.items()} == \
            {k: float(v) for k, v in jm.items()}
    x = rng.normal(size=300).astype(np.float32)
    y = (0.5 * x + rng.normal(size=300)).astype(np.float32)
    xt = np.round(x, 1)                      # many ties
    for a, b in ((x, y), (xt, y), (xt, np.round(y, 0))):
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        assert float(LS.pearsonr(ta, tb)) == pytest.approx(
            float(JLS.pearsonr(ja, jb)), rel=LOSS_RTOL)
        np.testing.assert_array_equal(LS._ranks(ta).numpy(),
                                      np.asarray(JLS._ranks(ja)))
        assert float(LS.spearmanr(ta, tb)) == pytest.approx(
            float(JLS.spearmanr(ja, jb)), rel=LOSS_RTOL)
    assert float(LS.mse(ta, tb)) == pytest.approx(float(JLS.mse(ja, jb)),
                                                  rel=LOSS_RTOL)


@pytest.mark.parametrize("modalities, freeze", [(TV, ()), (TVS, ()),
                                                (TVS, TV)],
                         ids=["tv", "tvs", "tvs-frozen"])
def test_one_step_gradients_match_reference(cfg, d1, modalities, freeze):
    jp, pp = _jax_params(cfg, modalities)
    batch = d1.batch(np.arange(64), modalities)
    jcfg = JC.tiny()

    def loss_fn(p):
        out = JE.forward(p, jcfg, batch, modalities, freeze=freeze)
        return JET.multitask_loss(out, batch["labels"])[0]
    jloss, jg = jax.value_and_grad(loss_fn)(jp)
    ploss, pg = ET.value_and_grad(pp, cfg, batch, modalities, freeze=freeze)
    assert float(ploss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    _same_tree(jax.device_get(jg), pg, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    for k in freeze:
        assert all(not torch.any(g) for g in T.leaves(pg[k]))


def test_loss_curve_matches_reference(cfg, d1):
    tr, _, _ = D.splits(d1)
    jp, pp = _jax_params(cfg, TV, seed=1)
    _, jl = JET.train(JC.tiny(), D.loader(tr, 32, modalities=TV),
                      modalities=TV, steps=10, params=jp)
    _, pl = ET.train(cfg, D.loader(tr, 32, modalities=TV), modalities=TV,
                     steps=10, params=pp)
    np.testing.assert_allclose(pl, jl, rtol=CURVE_RTOL)


def test_pmi_init_matches_reference(cfg):
    jp2, pp2 = _jax_params(cfg, TV, seed=2)
    jp3, mods = JET.pmi_init(JC.tiny(), jp2, seed=5)
    fresh = from_jax_numpy(jax.device_get(
        JE.init_params(JC.tiny(), jax.random.PRNGKey(5), TVS)), "cpu")
    pp3, pmods = ET.pmi_init(cfg, pp2, fresh=fresh)
    assert pmods == mods == TVS
    _same_tree(jax.device_get(jp3), pp3)
    # without ``fresh`` the scene encoder and heads come from a generator
    drawn, _ = ET.pmi_init(cfg, pp2, seed=5)
    assert drawn["text"] is pp2["text"]
    fc2 = cfg.feature_dims["text"] + cfg.feature_dims["vitals"]
    assert torch.equal(drawn["heads"]["medicine"]["w"][:fc2],
                       pp2["heads"]["medicine"]["w"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_cross_restores(tmp_path, cfg, writer):
    jp2, pp2 = _jax_params(cfg, TV, seed=3)
    jp3, pp3 = _jax_params(cfg, TVS, seed=4)
    jtree, ptree = {"m2": jp2, "m3": jp3}, {"m2": pp2, "m3": pp3}
    path = tmp_path / "ems.npz"
    if writer == "jax":
        JCKPT.save(path, jtree, metadata={"by": writer})
        got = CKPT.restore(path, T.tree_map(torch.zeros_like, ptree))
        _same_tree(jax.device_get(jtree), got)
        assert CKPT.metadata(path) == {"by": writer}
    else:
        CKPT.save(path, ptree, metadata={"by": writer})
        got = JCKPT.restore(path, jax.tree.map(np.asarray, jtree))
        _same_tree(got, ptree)
        assert JCKPT.metadata(path) == {"by": writer}
    assert json.loads(path.with_suffix(".json").read_text())["keys"] == \
        sorted("/".join(map(str, p)) for p, _ in T.paths(ptree))


def test_training_never_calls_flash_attention(cfg, d1):
    """The port's default config serves through the flash kernel; the
    trainer swaps in the einsum attention, so a step calls the flash
    wrapper 0 times (and its autograd guard never fires). With the flash
    config it trains as with the einsum one: the same loss, and leaves
    within 1e-6 (the embedding's backward accumulates its rows in a
    parallel order, so two identical steps differ by an ulp there)."""
    assert cfg.use_flash_text
    batch = d1.batch(np.arange(32), TV)
    _, pp = _jax_params(cfg, TV)
    calls, launches = FA.flash_attention.calls, FA.flash_attention.launches
    step, init = ET.make_train_step(cfg, TV)
    p_flash, _, l_flash = step(pp, init(pp), batch)
    assert FA.flash_attention.calls == calls
    assert FA.flash_attention.launches == launches
    step, init = ET.make_train_step(dataclasses.replace(
        cfg, use_flash_text=False), TV)
    p_ein, _, l_ein = step(pp, init(pp), batch)
    assert torch.equal(l_flash, l_ein)
    for a, b in zip(T.leaves(p_flash), T.leaves(p_ein)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    # a forward through the flash path under autograd raises, loudly
    live = T.tree_map(lambda p: p.detach().requires_grad_(True), pp)
    with pytest.raises(RuntimeError, match="no backward"):
        E.forward(live, cfg, ET.to_device(batch, "cpu"), TV)


# ------------------------------------------------------------- launcher

def _launch(*args, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)


def test_launcher_trains_on_cpu_and_writes_a_reference_checkpoint(tmp_path):
    out = tmp_path / "ems.npz"
    r = _launch("--device", "cpu", "--text-encoder", "microbert",
                "--steps", "10", "--batch", "32", "--d1-size", "300",
                "--d2-size", "120", "--out", str(out), tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "2-modal test" in r.stdout and "3-modal PMI test" in r.stdout
    assert f"checkpoint -> {out}" in r.stdout
    jcfg = JC.config(text_encoder="microbert", vocab_size=2048)
    key = jax.random.PRNGKey(0)
    template = jax.tree.map(np.asarray, {
        "m2": JE.init_params(jcfg, key, TV),
        "m3": JE.init_params(jcfg, key, TVS)})
    got = JCKPT.restore(out, template)
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(got))
    meta = JCKPT.metadata(out)
    assert set(meta) == {"cfg", "metrics2", "metrics3"}
    assert 0.0 <= meta["metrics3"]["protocol_top1"] <= 1.0


def test_launcher_refuses_lm_training_naming_item_11(tmp_path):
    r = _launch("--model", "mistral-nemo-12b", tmp_path=tmp_path)
    assert r.returncode != 0
    assert "item 11" in r.stderr
    r = _launch("--steps", "1", tmp_path=tmp_path)      # no card here
    assert r.returncode != 0 and "RuntimeError" in r.stderr
