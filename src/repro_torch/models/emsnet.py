"""EMSNet: the paper's multimodal multitask model, in PyTorch.

Three backbone encoders (paper Table 1):
  * text:   TinyBERT / MobileBERT / BERTBase — bidirectional transformer
            over symptom-sentence tokens, masked mean-pooled to F_T.
  * vitals: RNN / LSTM / GRU over the (T, 6) time series -> F_V.
  * scene:  FC over the object-detection one-hot -> F_I.
Feature concatenation F_C = [F_T ; F_V ; F_I], then three headers:
protocol (46-way), medicine type (18-way), quantity (regression).

Every encoder is an independent function over its own parameter
subtree — the property EMSServe's modality-aware splitter exploits.
Functions, parameter keys and semantics follow ``repro.models.emsnet``;
text attention goes through ``kernels.ops.flash_attention`` when
``cfg.use_flash_text`` is set (the port's default).

The text and vitals encoders also take the ragged packed payload of
``core.bucketing.RaggedBatch`` (many rows in one buffer, one call) and
return one feature row per packed row.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.emsnet import EMSNetConfig
from ..kernels import ops
from . import layers as L

ALL_MODALITIES = ("text", "vitals", "scene")


# ----------------------------------------------------------------------
# Text encoder (BERT-class, bidirectional)
# ----------------------------------------------------------------------

def _block_init(gen, d, ff, device):
    return {
        "ln1": L.layernorm_init(d, device=device),
        "wqkv": L.dense_init(gen, d, 3 * d, bias=True, device=device),
        "wo": L.dense_init(gen, d, d, bias=True, device=device),
        "ln2": L.layernorm_init(d, device=device),
        "w1": L.dense_init(gen, d, ff, bias=True, device=device),
        "w2": L.dense_init(gen, ff, d, bias=True, device=device),
    }


def text_encoder_init(gen, cfg: EMSNetConfig, *, device):
    n_layers, d, _, ff = cfg.text_dims
    return {
        "tok": L.embedding_init(gen, cfg.vocab_size, d, device=device),
        "pos": L.embedding_init(gen, cfg.max_text_len, d, device=device),
        "ln": L.layernorm_init(d, device=device),
        "blocks": [_block_init(gen, d, ff, device) for _ in range(n_layers)],
    }


def _bert_block(p, x, mask, heads, *, kv_lengths=None, segments=None):
    """``kv_lengths`` (B,) routes attention through the flash kernel's
    key-padding mode, ``segments=(seg_ids, block)`` through its segment
    mode; with neither, the materialised einsum attention runs over
    ``mask``: (B, S) key mask, or (B, S, S) (query, key) pair mask. All
    three see the same qkv/wo projections."""
    B, S, d = x.shape
    hd = d // heads
    h = L.layernorm(p["ln1"], x)
    qkv = L.dense(p["wqkv"], h).reshape(B, S, 3, heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # strided views
    if segments is not None:
        seg, block = segments
        att = ops.flash_attention(q, k, v, causal=False, segment_ids=seg,
                                  block_q=block, block_k=block)
    elif kv_lengths is not None:
        att = ops.flash_attention(q, k, v, causal=False,
                                  kv_lengths=kv_lengths)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        m = mask[:, None] if mask.dim() == 3 else mask[:, None, None, :]
        s = torch.where(m, s, torch.full_like(s, -1e30))
        w = torch.softmax(s.float(), dim=-1).to(x.dtype)
        att = torch.einsum("bhqk,bkhd->bqhd", w, v)
    x = x + L.dense(p["wo"], att.reshape(B, S, d))
    h = L.layernorm(p["ln2"], x)
    x = x + L.dense(p["w2"], F.gelu(L.dense(p["w1"], h), approximate="tanh"))
    return x


def _pool(x, mask):
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def text_encoder(p, cfg: EMSNetConfig, tokens):
    """tokens: (B, S) int, 0 = PAD, or a ragged payload dict from
    ``RaggedBatch.pack("text", ...)`` (keys tokens/row_ids/pos/offsets/
    lengths). Returns F_T (B, d_text); for the ragged form, one feature
    row per packed row.

    The flash path assumes PAD-only suffixes (valid tokens first), which
    both the tokenizer layout and the bucketer's right-padding
    guarantee; the einsum and segment paths handle arbitrary masks. With
    ``cfg.flash_segments`` the natural path runs the segment-masked
    kernel, S padded to a ``cfg.flash_block`` multiple and positions
    clamped to the positional table."""
    if isinstance(tokens, dict):
        return _text_encoder_ragged(p, cfg, tokens)
    _, _, heads, _ = cfg.text_dims
    if cfg.use_flash_text and cfg.flash_segments:
        b = cfg.flash_block
        S = tokens.shape[1]
        Sp = -(-S // b) * b
        tokens = F.pad(tokens, (0, Sp - S))
        mask = tokens > 0
        seg = torch.where(mask, 0, -1).to(torch.int32)
        pos = torch.clamp(torch.arange(Sp, device=tokens.device),
                          max=cfg.max_text_len - 1)
        x = L.embed(p["tok"], tokens) + p["pos"]["emb"][pos][None]
        for blk in p["blocks"]:
            x = _bert_block(blk, x, mask, heads, segments=(seg, b))
        return _pool(L.layernorm(p["ln"], x), mask)
    mask = tokens > 0
    S = tokens.shape[1]
    lengths = mask.sum(-1).to(torch.int32) if cfg.use_flash_text else None
    x = L.embed(p["tok"], tokens) + p["pos"]["emb"][None, :S]
    for blk in p["blocks"]:
        x = _bert_block(blk, x, mask, heads, kv_lengths=lengths)
    return _pool(L.layernorm(p["ln"], x), mask)


def _text_encoder_ragged(p, cfg: EMSNetConfig, packed):
    """Concatenated ragged text: ONE call encodes every pending row.

    Attention is segment-masked by the pack's row ids (the flash
    kernel's segment mode at ``cfg.flash_block``, or a materialised
    pair mask without ``cfg.use_flash_text``), the positional table is
    gathered at each position's within-row index, and pooling gathers a
    ``max_text_len`` window at each row's offset: the masked mean over
    valid tokens, as the natural path pools. Gap and tail positions
    carry id -1, so they are masked as keys in every block and left out
    of every pool."""
    _, _, heads, _ = cfg.text_dims
    toks = packed["tokens"]                         # (1, T)
    seg = packed["row_ids"][None, :]                # (1, T)
    T = toks.shape[1]
    mask = seg >= 0
    x = L.embed(p["tok"], toks) + p["pos"]["emb"][packed["pos"]][None]
    if cfg.use_flash_text:
        attn_mask, kw = mask, {"segments": (seg, cfg.flash_block)}
    else:
        attn_mask = (seg[:, :, None] == seg[:, None, :]) & mask[:, None, :]
        kw = {}
    for blk in p["blocks"]:
        x = _bert_block(blk, x, attn_mask, heads, **kw)
    x = L.layernorm(p["ln"], x)
    offsets, lengths = packed["offsets"], packed["lengths"]
    cap = min(cfg.max_text_len, T)
    win = torch.arange(cap, device=toks.device)
    idx = torch.clamp(offsets[:, None].long() + win[None, :], 0, T - 1)
    xw = x[0][idx]                                  # (R, cap, d)
    mw = (win[None, :] < lengths[:, None]) & (toks[0][idx] > 0)
    return _pool(xw, mw)


# ----------------------------------------------------------------------
# Vitals encoder (RNN / LSTM / GRU)
# ----------------------------------------------------------------------

def vitals_encoder_init(gen, cfg: EMSNetConfig, *, device):
    d_in, h = cfg.n_vitals, cfg.vitals_hidden
    gates = {"rnn": 1, "gru": 3, "lstm": 4}[cfg.vitals_encoder]
    return {
        "wx": L.dense_init(gen, d_in, gates * h, bias=True, device=device),
        "wh": L.dense_init(gen, h, gates * h, device=device),
    }


def vitals_encoder(p, cfg: EMSNetConfig, vitals):
    """vitals: (B, T, n_vitals) float, a bucketed payload
    ``{"x": (B, T_b, n_vitals), "len": (B,) int}`` zero-padded to a
    length bucket, whose padded steps leave the carry as it was, or a
    ragged payload from ``RaggedBatch.pack("vitals", ...)`` (keys
    x/reset/offsets/lengths: many series concatenated along time, B=1),
    whose ``reset`` zeroes the carry at each row's first step. Returns
    F_V (B, vitals_hidden); for the ragged form, one row per packed row,
    the state after the row's last step (zeros for an empty row).

    The scan is a loop over T in the reference's own gate conventions
    (GRU reset gate applied before the recurrent product, LSTM forget
    gate biased by +1), which are not those of ``nn.GRU``/``nn.LSTM``."""
    length = reset = None
    if isinstance(vitals, dict) and "offsets" in vitals:
        x, reset = vitals["x"], vitals["reset"]
    elif isinstance(vitals, dict):
        x, length = vitals["x"], vitals["len"]
    else:
        x = vitals
    B, T, _ = x.shape
    h = cfg.vitals_hidden
    kind = cfg.vitals_encoder
    wh = p["wh"]["w"]
    x_proj = L.dense(p["wx"], x)                     # (B, T, gates*h)

    def rnn_step(hp, xt):
        return torch.tanh(xt + hp @ wh)

    def gru_step(hp, xt):
        zr = xt + hp @ wh
        z = torch.sigmoid(zr[:, :h])
        r = torch.sigmoid(zr[:, h:2 * h])
        n = torch.tanh(xt[:, 2 * h:] + (r * hp) @ wh[:, 2 * h:])
        return (1 - z) * n + z * hp

    def lstm_step(carry, xt):
        hp, cp = carry
        g = xt + hp @ wh
        i = torch.sigmoid(g[:, :h])
        f = torch.sigmoid(g[:, h:2 * h] + 1.0)
        o = torch.sigmoid(g[:, 2 * h:3 * h])
        c = f * cp + i * torch.tanh(g[:, 3 * h:])
        return o * torch.tanh(c), c

    step = {"lstm": lstm_step, "gru": gru_step, "rnn": rnn_step}[kind]
    h0 = torch.zeros((B, h), dtype=x.dtype, device=x.device)
    carry = (h0, h0) if kind == "lstm" else h0
    valid = None                                     # (T, B, 1): step t is real
    if length is not None:
        valid = (torch.arange(T, device=x.device)[:, None]
                 < length.to(x.device)[None, :])[..., None]
    hs = []                                          # ragged: h after each step
    for t in range(T):
        if reset is not None:
            # a packed row's first step starts from the zero state
            carry = (tuple(torch.where(reset[t], h0, c_) for c_ in carry)
                     if kind == "lstm" else torch.where(reset[t], h0, carry))
        new = step(carry, x_proj[:, t])
        if valid is None:
            carry = new
        elif kind == "lstm":
            carry = tuple(torch.where(valid[t], n_, c_)
                          for n_, c_ in zip(new, carry))
        else:
            carry = torch.where(valid[t], new, carry)
        if reset is not None:
            hs.append(carry[0] if kind == "lstm" else carry)
    if reset is not None:
        offsets, lengths = vitals["offsets"], vitals["lengths"]
        idx = torch.clamp(offsets.long() + lengths.long() - 1, 0, T - 1)
        hfin = torch.stack(hs)[idx, 0]                # (R, h)
        return torch.where((lengths > 0)[:, None], hfin,
                           torch.zeros_like(hfin))
    return carry[0] if kind == "lstm" else carry


# ----------------------------------------------------------------------
# Scene encoder + headers
# ----------------------------------------------------------------------

def scene_encoder_init(gen, cfg: EMSNetConfig, *, device):
    return {"fc": L.dense_init(gen, cfg.scene_dim, cfg.scene_hidden,
                               bias=True, device=device)}


def scene_encoder(p, cfg: EMSNetConfig, scene):
    """scene: (B, scene_dim) one-hot-ish floats. Returns F_I."""
    return torch.relu(L.dense(p["fc"], scene))


def heads_init(gen, cfg: EMSNetConfig, modalities, *, device):
    dims = cfg.feature_dims
    fc_dim = sum(dims[m] for m in modalities)
    return {
        "protocol": L.dense_init(gen, fc_dim, cfg.n_protocols, bias=True,
                                 device=device),
        "medicine": L.dense_init(gen, fc_dim, cfg.n_medicines, bias=True,
                                 device=device),
        "quantity": L.dense_init(gen, fc_dim, 1, bias=True, device=device),
    }


def fuse_and_heads(p, features: dict, modalities):
    """Concatenate per-modality features (paper's fusion) and run headers."""
    fc = torch.cat([features[m] for m in modalities], dim=-1)
    return {
        "protocol_logits": L.dense(p["protocol"], fc),
        "medicine_logits": L.dense(p["medicine"], fc),
        "quantity": L.dense(p["quantity"], fc)[..., 0],
    }


def slice_heads(heads, cfg: EMSNetConfig, all_modalities, subset):
    """Restrict full-fusion head params to a modality subset: the head
    over the subset's features is the full head with only the weight rows
    of the subset's slice of F_C (biases unchanged)."""
    dims = cfg.feature_dims
    offs, off = {}, 0
    for m in all_modalities:
        offs[m] = off
        off += dims[m]
    subset = tuple(m for m in all_modalities if m in set(subset))

    def take(p):
        w = torch.cat([p["w"][offs[m]:offs[m] + dims[m]] for m in subset],
                      dim=0)
        return {"w": w, **({"b": p["b"]} if "b" in p else {})}

    return {k: take(v) for k, v in heads.items()}


def partial_forward(params, cfg: EMSNetConfig, batch: dict, subset,
                    all_modalities=ALL_MODALITIES):
    """One-shot forward restricted to an observed-modality subset: encode
    only the subset, fuse through the sliced full heads."""
    subset = tuple(m for m in all_modalities if m in set(subset))
    feats = {m: encode(params, cfg, m, batch[m]) for m in subset}
    ph = slice_heads(params["heads"], cfg, all_modalities, subset)
    return fuse_and_heads(ph, feats, subset)


# ----------------------------------------------------------------------
# Whole model
# ----------------------------------------------------------------------

ENCODERS = {
    "text": (text_encoder_init, text_encoder),
    "vitals": (vitals_encoder_init, vitals_encoder),
    "scene": (scene_encoder_init, scene_encoder),
}


def init_params(cfg: EMSNetConfig, gen: torch.Generator,
                modalities=ALL_MODALITIES, *, device):
    p = {m: ENCODERS[m][0](gen, cfg, device=device) for m in modalities}
    p["heads"] = heads_init(gen, cfg, modalities, device=device)
    return p


def encode(params, cfg: EMSNetConfig, modality: str, inputs):
    return ENCODERS[modality][1](params[modality], cfg, inputs)


def forward(params, cfg: EMSNetConfig, batch: dict,
            modalities=ALL_MODALITIES, *, freeze=()):
    """Full multimodal forward. batch keys = modality names."""
    feats = {}
    for m in modalities:
        f = encode(params, cfg, m, batch[m])
        feats[m] = f.detach() if m in freeze else f
    return fuse_and_heads(params["heads"], feats, modalities)
