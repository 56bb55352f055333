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

  * batch axis (multi-session coalescing): rows above ``n`` are
    zero/PAD rows the caller slices away.

Inputs longer than ``max_bucket`` are cropped to it: vitals keep their
most recent steps (a sliding window), text keeps its leading tokens
(the valid prefix).

:class:`RaggedBatch` is the other layout of a flush: rows of different
lengths packed back to back into one buffer, one encoder call per
modality. Both layouts are built on the host from the sessions' host
inputs and reach the card with one copy per key (:func:`to_device`).

The port of ``repro.core.bucketing``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
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


def to_device(tree, device):
    """Stage a payload (a tensor or a dict of tensors) on ``device``: one
    host-to-device copy per tensor, from pinned memory and without
    waiting on the card, so a flush that stages its batches keeps its
    one host sync. CPU targets get the tensors as they are."""
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if device.type == "cpu" or tree.device == device:
        return tree
    return tree.pin_memory().to(device, non_blocking=True)


def stack_bucketed(payloads, batch_bucket: int):
    """Coalesce per-session payloads (each batch dim 1, same bucketed
    length) into one batch of ``batch_bucket`` rows; surplus rows are
    zero/PAD padding (zero ``len`` for masked-vitals dicts, so padded
    rows encode to the zero initial state). Returns the stacked payload,
    on the payloads' device; row i -> session i for the first
    ``len(payloads)`` rows."""
    if isinstance(payloads[0], dict):
        keys = payloads[0].keys()
        for i, p in enumerate(payloads[1:], start=1):
            if p.keys() != keys:
                raise ValueError(
                    f"stack_bucketed: payload 0 has keys {sorted(keys)} but "
                    f"payload {i} has {sorted(p.keys())}; refusing to drop "
                    "mismatched keys")
        return {k: pad_axis(torch.cat([p[k] for p in payloads], dim=0),
                            batch_bucket, axis=0)
                for k in keys}
    return pad_axis(torch.cat(list(payloads), dim=0), batch_bucket, axis=0)


@dataclass
class RaggedBatch:
    """Concatenated ragged layout: rows of different natural lengths
    packed back to back into ONE flat buffer, so a flush issues a single
    encoder call per modality however many length buckets are live
    (against one call per ``(modality, bucket)`` for :class:`Bucketer`).

    ``pack`` returns the payload dict the ragged-aware encoders consume.
    For ``text`` (rows of (1, S_i) int):

      * ``tokens``  (1, T) int32 — rows concatenated, PAD=0 between and
        after; each row starts at a multiple of ``align`` (the flash
        kernel's segment block);
      * ``row_ids`` (T,) int32 — position -> row index, -1 on padding
        AND on a row's interior PAD tokens (so the segment mask equals
        the per-row ``tokens > 0`` key mask);
      * ``pos``     (T,) int32 — position within the row (for the
        positional embedding gather);
      * ``offsets`` (R,) int32 / ``lengths`` (R,) int32 — row i occupies
        ``[offsets[i], offsets[i] + lengths[i])``; surplus rows (R is
        padded to a power of two) have length 0 and offset == the total
        packed extent, so the segments tile the buffer exactly.

    For ``vitals`` (rows of (1, S_i, n) float): ``x`` (1, T, n) packed
    with ``align=1`` (the scan has no cross-length reduction), plus
    ``reset`` (T, 1, 1) bool marking each row's first step, and the same
    ``offsets``/``lengths``.

    T and R are padded to powers of two (T floored at ``min_total``, R
    at ``min_rows``), so the packed shapes stay O(log^2 total) like the
    bucketer's. Rows longer than ``max_lengths[modality]`` are cropped
    exactly like ``Bucketer.fit`` (text keeps its head, vitals its
    tail). ``histogram`` counts packed ``(modality, (R, T))`` shapes
    served.
    """
    align: int = 8
    min_total: int = 8
    min_rows: int = 1
    max_lengths: Dict[str, int] = field(default_factory=dict)
    histogram: Dict[tuple, int] = field(default_factory=dict)

    def _crop(self, modality: str, x):
        cap = self.max_lengths.get(modality)
        if cap is not None and x.shape[1] > cap:
            x = pad_axis(x, cap, axis=1,
                         keep="head" if modality == "text" else "tail")
        return x

    def _layout(self, lengths, align: int):
        offs, o = [], 0
        for n in lengths:
            offs.append(o)
            if n:
                o += -(-n // align) * align
        total = o
        T = max(self.min_total, next_pow2(max(total, 1)))
        R = max(self.min_rows, next_pow2(max(len(lengths), 1)))
        return offs, total, T, R

    @staticmethod
    def _index_vectors(offs, lens, total, R):
        offsets = np.full((R,), total, np.int32)
        lengths = np.zeros((R,), np.int32)
        offsets[:len(offs)] = offs
        lengths[:len(lens)] = lens
        return offsets, lengths

    def pack(self, modality: str, payloads, device="cpu"):
        """payloads: list of (1, S_i, ...) host tensors or arrays (one per
        session row). The layout is built on the host; the returned
        tensors lie on ``device``, one copy per key."""
        rows = [np.asarray(self._crop(modality, torch.as_tensor(p)))
                for p in payloads]
        lens = [int(r.shape[1]) for r in rows]
        if modality == "text":
            offs, total, T, R = self._layout(lens, self.align)
            toks = np.zeros((1, T), np.int32)
            seg = np.full((T,), -1, np.int32)
            pos = np.zeros((T,), np.int32)
            for i, (r, o, n) in enumerate(zip(rows, offs, lens)):
                rv = r[0].astype(np.int32)
                toks[0, o:o + n] = rv
                seg[o:o + n] = np.where(rv > 0, i, -1)
                pos[o:o + n] = np.arange(n)
            offsets, lengths = self._index_vectors(offs, lens, total, R)
            self._count(modality, (R, T))
            out = {"tokens": toks, "row_ids": seg, "pos": pos,
                   "offsets": offsets, "lengths": lengths}
        elif modality == "vitals":
            offs, total, T, R = self._layout(lens, 1)
            n_feat = int(rows[0].shape[2])
            x = np.zeros((1, T, n_feat), np.float32)
            reset = np.zeros((T, 1, 1), bool)
            for r, o, n in zip(rows, offs, lens):
                if n:
                    x[0, o:o + n] = r[0]
                    reset[o] = True
            offsets, lengths = self._index_vectors(offs, lens, total, R)
            self._count(modality, (R, T))
            out = {"x": x, "reset": reset, "offsets": offsets,
                   "lengths": lengths}
        else:
            raise ValueError(f"RaggedBatch.pack: no ragged layout for "
                             f"modality {modality!r} (fixed-size payloads "
                             "stack on the batch axis instead)")
        return to_device({k: torch.from_numpy(v) for k, v in out.items()},
                         device)

    def _count(self, modality: str, shape):
        key = (modality, shape)
        self.histogram[key] = self.histogram.get(key, 0) + 1

    def n_shapes(self) -> int:
        return len(self.histogram)
