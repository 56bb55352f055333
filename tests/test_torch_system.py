"""End-to-end behaviour of the port's system, on the CPU at the tiny
config: the three ``test_e2e_*`` cases of ``tests/test_system.py``
mirrored on the port. EMSNet is trained on the port's synthetic NEMSIS
data (``training.emsnet_trainer``, the reference's step counts), split
by EMSServe, and a Table-6 episode is streamed through the per-event
engine (tasks 1-5, caching, offloading).

The reference file's ``test_lowering_on_host_mesh`` is mirrored in
``tests/test_torch_dist_host.py``; ``test_dryrun_artifacts_complete``
reads the dry-run sweep, whose counterpart is ROADMAP item 12's second
half.
"""
import pytest
import torch

from repro_torch.core import (AdaptiveOffloadPolicy, BandwidthTrace, EMSServe,
                              HeartbeatMonitor, ProfileTable, emsnet_module,
                              nlos_bandwidth, split, table6)
from repro_torch.configs.emsnet import tiny
from repro_torch.core import medmath as MM
from repro_torch.data import synthetic_nemsis as D
from repro_torch.training import emsnet_trainer as ET


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module trains: the suite runs six
    test processes on the machine's cores, and tiny-config training
    spread over every core in each of them spends its time at thread
    barriers (847 s for this file's training against 17 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained_system():
    """Train M1/M2/M3 on synthetic D1/D2, return split models + params."""
    cfg = tiny()
    d1 = D.generate(cfg, 1000, seed=0)
    tr, _, te = D.splits(d1)
    p1, _ = ET.train(cfg, D.loader(tr, 64, modalities=("text",)),
                     modalities=("text",), steps=60, device="cpu")
    p2, _ = ET.train(cfg, D.loader(tr, 64, modalities=("text", "vitals")),
                     modalities=("text", "vitals"), steps=60, device="cpu")
    d2 = D.generate(cfg, 300, seed=5, modal3=True)
    tr2, _, _ = D.splits(d2)
    p3, _ = ET.pmi_finetune(cfg, p2, D.loader(tr2, 32), steps=40)
    mods = {"m1": emsnet_module(cfg, ("text",)),
            "m2": emsnet_module(cfg, ("text", "vitals")),
            "m3": emsnet_module(cfg, ("text", "vitals", "scene"))}
    splits = {k: split(m) for k, m in mods.items()}
    params = {"m1": p1, "m2": p2, "m3": p3}
    return cfg, splits, params, te


def _episode_payloads(te):
    return {"text": te.text[:1], "vitals": te.vitals[:1],
            "scene": te.scene[:1]}


def test_e2e_episode_with_trained_models(trained_system):
    """Full pipeline: episode stream -> recommendations -> med-math."""
    cfg, splits, params, te = trained_system
    payloads = _episode_payloads(te)
    pol = AdaptiveOffloadPolicy(
        ProfileTable(base={"enc:text": 0.05, "enc:vitals": 0.001,
                           "enc:scene": 0.001, "tail": 0.001, "full": 0.06}),
        HeartbeatMonitor(BandwidthTrace.static(nlos_bandwidth(5))))
    eng = EMSServe(splits, params, policy=pol, cached=True, device="cpu")
    eng.run_episode(table6()[1], lambda ev: payloads[ev.modality])

    final = eng.records[-1].recommendation
    assert final is not None
    assert tuple(final["protocol_logits"].shape) == (1, cfg.n_protocols)
    assert tuple(final["medicine_logits"].shape) == (1, cfg.n_medicines)
    # tasks 4 & 5 post-processing on the quantity head output
    qty = abs(float(final["quantity"][0])) + 0.5
    dosage = MM.dosage_from_label(qty, "adrenaline")
    assert dosage["dosage_ml"] > 0
    # the model used at the end integrates all three modalities
    assert eng.records[-1].model == "m3"


def test_e2e_recommendations_track_model_upgrades(trained_system):
    """As modalities arrive, the engine upgrades M1 -> M2 -> M3."""
    cfg, splits, params, te = trained_system
    payloads = _episode_payloads(te)
    eng = EMSServe(splits, params, cached=True, real_time=True, device="cpu")
    models_used = []
    for ev in table6()[1]:
        rec = eng.on_event(ev, payloads[ev.modality])
        models_used.append(rec.model)
    assert models_used[0] == "m1"          # speech only
    assert models_used[1] == "m2"          # + vitals
    assert models_used[-1] == "m3"         # + scene
    assert eng.cache.hits > 0


def test_e2e_accuracy_sanity(trained_system):
    """Trained 2-modal model is far above chance on protocol selection."""
    cfg, splits, params, te = trained_system
    m = ET.evaluate(params["m2"], cfg, te, ("text", "vitals"))
    assert m["protocol_top1"] > 5.0 / cfg.n_protocols
