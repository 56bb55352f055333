"""Synthetic NEMSIS-schema multimodal EMS dataset (D1/D2 analogues).

NEMSIS itself is request-gated, so this module implements a generative
stand-in with the *documented* schema and preprocessing (paper §3.1 +
Appendix A):
  * 46 protocols, 18 medicine types, quantity regression labels;
  * symptom text: 4 concatenated symptom fields drawn from
    protocol-conditioned vocabulary (primary symptom, primary
    impression, associated symptom, secondary impression);
  * 6 vitals time series (BP, HR, PO, RR, CO2, BG) with
    protocol-conditioned means, NEMSIS-style recording artifacts
    (default-max outliers like HR=500), variable lengths;
  * scene flags (alcohol / pills / medicine bottle) correlated with the
    protocol (paper §2.3: pill/alcohol presence narrows protocols);
  * preprocessing: 2%-98% percentile clipping, zero *left*-padding to
    30 steps, cross-sample z-score / min-max normalization.

The generative process ties labels to all three modalities so that the
paper's comparative claims (multimodal > unimodal; PMI > scratch on the
small 3-modal set) are testable directionally.

The port's copy of ``repro.data.synthetic_nemsis``: the same numpy draws
from ``np.random.default_rng`` in the same order, so a seed gives the
same arrays, element for element. It stays numpy; the trainer turns a
batch into tensors on its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..configs.emsnet import EMSNetConfig

VITALS = ("BP", "HR", "PO", "RR", "CO2", "BG")
VITAL_RANGES = {  # plausible clinical ranges (lo, hi) and default-error value
    "BP": (60, 220, 999), "HR": (30, 180, 500), "PO": (60, 100, 0),
    "RR": (6, 40, 99), "CO2": (15, 60, 0), "BG": (40, 400, 2000),
}
WORDS_PER_FIELD = 4
N_FIELDS = 4          # primary symptom/impression, assoc. symptom, secondary


@dataclass
class Dataset:
    text: np.ndarray          # (N, max_text_len) int32 token ids, 0=PAD
    vitals: np.ndarray        # (N, vitals_len, 6) float32 normalized
    scene: np.ndarray         # (N, 3) float32 {0,1}
    protocol: np.ndarray      # (N,) int32
    medicine: np.ndarray      # (N,) int32
    quantity: np.ndarray      # (N,) float32 normalized

    def __len__(self):
        return len(self.protocol)

    def subset(self, idx):
        return Dataset(self.text[idx], self.vitals[idx], self.scene[idx],
                       self.protocol[idx], self.medicine[idx], self.quantity[idx])

    def batch(self, idx, modalities=("text", "vitals", "scene")):
        b = {m: getattr(self, m)[idx] for m in modalities}
        b["labels"] = {"protocol": self.protocol[idx],
                       "medicine": self.medicine[idx],
                       "quantity": self.quantity[idx]}
        return b


def _protocol_params(cfg: EMSNetConfig, rng):
    """Per-protocol generative parameters."""
    P = cfg.n_protocols
    vocab_per_proto = 24
    word_bank = rng.integers(5, cfg.vocab_size, size=(P, vocab_per_proto))
    vital_mean = rng.uniform(0.25, 0.75, size=(P, len(VITALS)))
    # medicine conditional on protocol (sparse support of 3 options each)
    med_support = rng.integers(0, cfg.n_medicines, size=(P, 3))
    scene_prob = rng.uniform(0.05, 0.9, size=(P, 3))
    qty_base = rng.uniform(0.5, 8.0, size=(cfg.n_medicines,))
    return dict(word_bank=word_bank, vital_mean=vital_mean,
                med_support=med_support, scene_prob=scene_prob,
                qty_base=qty_base)


def generate(cfg: EMSNetConfig, n: int, *, seed: int = 0,
             modal3: bool = False) -> Dataset:
    """Raw event generation + the documented preprocessing pipeline."""
    rng = np.random.default_rng(seed)
    gp = _protocol_params(cfg, np.random.default_rng(1234))  # fixed world

    proto = rng.integers(0, cfg.n_protocols, size=n)
    med = gp["med_support"][proto, rng.integers(0, 3, size=n)]
    qty_raw = gp["qty_base"][med] * rng.lognormal(0, 0.35, size=n)

    # ---- text: 4 fields x words from the protocol's vocabulary ----
    L = cfg.max_text_len
    text = np.zeros((n, L), np.int32)
    n_words = min(N_FIELDS * WORDS_PER_FIELD, L)
    picks = rng.integers(0, gp["word_bank"].shape[1], size=(n, n_words))
    text[:, :n_words] = gp["word_bank"][proto[:, None], picks]
    # drop some words (shorter sentences)
    drop = rng.random((n, n_words)) < 0.15
    text[:, :n_words] = np.where(drop, 0, text[:, :n_words])

    # ---- vitals: protocol-conditioned random walks with artifacts ----
    T, V = cfg.vitals_len, len(VITALS)
    lens = rng.integers(max(1, T // 6), T + 1, size=n)
    lo = np.array([VITAL_RANGES[v][0] for v in VITALS], np.float32)
    hi = np.array([VITAL_RANGES[v][1] for v in VITALS], np.float32)
    bad = np.array([VITAL_RANGES[v][2] for v in VITALS], np.float32)
    mean = lo + gp["vital_mean"][proto] * (hi - lo)              # (n, V)
    walk = rng.normal(0, 0.03, size=(n, T, V)).cumsum(axis=1)
    raw = mean[:, None, :] * (1 + walk) \
        + rng.normal(0, 0.02, size=(n, T, V)) * (hi - lo)
    # inject NEMSIS default-value recording errors (~2% of entries)
    err = rng.random((n, T, V)) < 0.02
    raw = np.where(err, bad, raw)

    # ---- scene flags ----
    scene = (rng.random((n, 3)) < gp["scene_prob"][proto]).astype(np.float32)
    if modal3:
        # 3-modal events: scene flags sharpen the protocol signal
        med = np.where(scene[:, 1] > 0, gp["med_support"][proto, 0], med)

    # ================= preprocessing (Appendix A) =================
    # (1) 2%-98% percentile clipping per vital
    ql = np.quantile(raw, 0.02, axis=(0, 1))
    qh = np.quantile(raw, 0.98, axis=(0, 1))
    clipped = np.clip(raw, ql, qh)
    # (2) zero left-padding: only the last `len` steps are real
    t_idx = np.arange(T)[None, :, None]
    valid = t_idx >= (T - lens)[:, None, None]
    padded = np.where(valid, clipped, 0.0)
    # (3) cross-sample normalization (z-score over valid entries)
    flat = np.where(valid, padded, np.nan)
    mu = np.nanmean(flat, axis=(0, 1))
    sd = np.nanstd(flat, axis=(0, 1)) + 1e-6
    vitals = np.where(valid, (padded - mu) / sd, 0.0).astype(np.float32)

    # quantity labels: same clip + z-score discipline
    qlo, qhi = np.quantile(qty_raw, [0.02, 0.98])
    q = np.clip(qty_raw, qlo, qhi)
    q = (q - q.mean()) / (q.std() + 1e-6)

    return Dataset(text=text, vitals=vitals, scene=scene,
                   protocol=proto.astype(np.int32), medicine=med.astype(np.int32),
                   quantity=q.astype(np.float32))


def splits(ds: Dataset, *, seed=0, ratios=(3, 1, 1)):
    """Paper: 74821/24761/24761 = 3:1:1 train/val/test."""
    n = len(ds)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    a = n * ratios[0] // sum(ratios)
    b = n * (ratios[0] + ratios[1]) // sum(ratios)
    return ds.subset(order[:a]), ds.subset(order[a:b]), ds.subset(order[b:])


def loader(ds: Dataset, batch_size: int, *, seed=0, shuffle=True,
           modalities=("text", "vitals", "scene"), drop_last=True):
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(len(ds)) if shuffle else np.arange(len(ds))
        stop = len(ds) - batch_size + 1 if drop_last else len(ds)
        for i in range(0, stop, batch_size):
            yield ds.batch(order[i:i + batch_size], modalities)
