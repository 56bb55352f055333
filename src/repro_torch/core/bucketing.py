"""Shape bucketing: bounded shapes for variable-length inputs.

An EMS episode grows its vitals time series with every event and text
utterances vary in token count. The bucketer pads every variable-length
input up to the next power-of-two length (floored at ``min_bucket``,
clamped at ``max_bucket``), so the encoders see O(log max_len) distinct
shapes — what a later per-shape CUDA-graph capture needs.

Padding must not change the math:
  * text: PAD id 0 — the text encoder key-masks ``tokens > 0`` and
    mean-pools over the same mask;
  * vitals: zero-padded timesteps plus an explicit ``len`` vector; the
    recurrent encoders freeze their carry on padded steps (see
    ``models.emsnet.vitals_encoder``), so the final state equals the
    unpadded run's.

Inputs longer than ``max_bucket`` are cropped to it: vitals keep their
most recent steps (a sliding window), text keeps its leading tokens
(the valid prefix).

A copy of the per-event half of ``repro.core.bucketing``; batch
stacking and the ragged packed layout join with the batch engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.nn.functional as F


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def bucket_length(n: int, *, min_bucket: int = 8,
                  max_bucket: Optional[int] = None) -> int:
    b = max(min_bucket, next_pow2(n))
    if max_bucket is not None:
        # the cap itself is the top bucket (NOT rounded up: a
        # non-power-of-two cap like max_text_len=48 must never produce
        # inputs longer than the positional table)
        b = min(b, max_bucket)
    return b


def pad_axis(x, length: int, axis: int, pad_value=0, keep: str = "tail"):
    """Pad ``axis`` to ``length``; when cropping keep the trailing
    (``keep="tail"``, for streams where the recent window matters) or
    leading (``keep="head"``, for right-padded sequences whose valid
    prefix must survive) slice."""
    axis = axis % x.ndim
    n = x.shape[axis]
    if n == length:
        return x
    if n > length:
        return x.narrow(axis, n - length if keep == "tail" else 0, length)
    widths = [0, 0] * (x.ndim - axis)          # F.pad lists the last dim first
    widths[-1] = length - n
    return F.pad(x, widths, value=pad_value)


@dataclass
class Bucketer:
    """Pads per-modality payloads to bucketed lengths.

    ``fit`` returns the exact payload the (mask-aware) encoders consume:
      * text  (B, S) int    -> (B, S_b) int, PAD=0
      * vitals (B, T, n)    -> {"x": (B, T_b, n), "len": (B,) int32}
      * anything fixed-size -> passthrough
    """
    min_bucket: int = 8
    max_buckets: Dict[str, int] = field(default_factory=dict)
    # (modality, bucket) -> times served
    histogram: Dict[tuple, int] = field(default_factory=dict)

    def bucket(self, modality: str, n: int) -> int:
        return bucket_length(n, min_bucket=self.min_bucket,
                             max_bucket=self.max_buckets.get(modality))

    def _count(self, modality: str, b: int):
        key = (modality, b)
        self.histogram[key] = self.histogram.get(key, 0) + 1

    def fit(self, modality: str, x):
        if modality == "text":
            b = self.bucket(modality, x.shape[1])
            self._count(modality, b)
            # valid tokens are a prefix (PAD suffix): keep the head so a
            # crop drops PAD, not the utterance
            return pad_axis(x, b, axis=1, keep="head")
        if modality == "vitals":
            T = x.shape[1]
            b = self.bucket(modality, T)
            self._count(modality, b)
            return {"x": pad_axis(x, b, axis=1),
                    "len": torch.full((x.shape[0],), min(T, b),
                                      dtype=torch.int32, device=x.device)}
        return x

    def n_buckets(self) -> int:
        return len(self.histogram)
