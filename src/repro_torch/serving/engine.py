"""LLM serving engine: prefill + greedy decode with prefix caching.

The LLM zoo's analogue of EMSServe's per-modality feature cache: a
request whose prompt extends an already-served prompt (a system prompt,
an earlier turn) reuses the stored decode cache instead of encoding the
prefix again. The same prefix hashing over the prompt's numpy bytes,
hit/miss/re-decode logic and ``stats`` as the reference
``repro.serving.engine.LLMServer``, for every cache family of the zoo:
GQA KV ring buffers, MLA latents, Mamba and RWKV6 states, and the
conditioning keys and values of cross-attention layers (Llama-3.2-Vision's
``cross``, MusicGen's ``cond``), which prefill projects from
``Request.cond`` and decode reads unchanged. A multi-codebook prompt
(S, ncb) decodes (1, 1, ncb) tokens a step, greedy in each codebook, and
stops at ``eos_id`` when every codebook gives it.

The server keeps ONE decode cache of its own, with the token and the
position a decode step reads, and every step writes that cache in
place. On the card the decode step is captured as a CUDA graph over
that static state (``graphs.Graphed``, the counterpart of the
reference's jitted decode): one graph per (arch, B=1, ``cache_len``),
replayed at every step after the position is filled in. A prefill
(eager: each prompt length is its own program) or a prefix hit copies
its cache into the static one. The prefix cache holds snapshots, copied
when an entry is stored, so a stored entry stays byte-identical however
many later requests replay over the static cache.

One fault of the reference is not inherited. A prompt identical to a
stored one has no token left to encode, and the reference decodes the
prompt's last token again to get logits: harmless for a KV ring buffer
(the slot takes the same K and V again), but a recurrent state (RWKV6,
Mamba) folds that token in a second time and the answer differs from a
cold server's. The port keeps each stored prompt's last logits beside
its entry (``prefix_logits``, under the same key) and an exact hit
reuses them, decoding nothing; the stats are the reference's, which
never counted that decode.

Nor is a second. The reference keys a stored prompt on its tokens
alone, so a new image (``cond``) with the same or a longer prompt is
answered from the first image's cross keys and values. The port keys an
entry on the prompt and on the bytes of ``cond`` (or "none"): the same
``cond`` hits exactly where the reference's would, a new one misses and
is prefilled.
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..graphs import Graphed
from ..graphs import compile_count as _compile_count
from ..models import transformer as T


@dataclass
class Request:
    rid: str
    prompt: np.ndarray                  # (S,) or (S, ncb) int32
    max_new_tokens: int = 16
    cond: Optional[np.ndarray] = None   # (Cs, cond_dim) frontend embeddings
    eos_id: Optional[int] = None


@dataclass
class Result:
    rid: str
    tokens: np.ndarray
    prefix_hit: bool
    prefill_tokens: int                 # tokens actually encoded


def _h(arr: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _decode_logits(state, *, cfg):
    """One decode step over the server's static state, written in place;
    returns the logits (B, 1, V), or (B, 1, ncb, V). The window is a
    value leaf of the state, so a graph is keyed by it."""
    return T.decode_step(state["params"], cfg, state["tokens"],
                         state["cache"], state["t"],
                         window_attn=state["window"])[0]


class LLMServer:
    """Greedy server for one architecture, one request at a time (B=1),
    on ``device`` (``cuda`` unless the caller asks for the CPU); ``params``
    must live there. ``window`` masks the plain attention layers of both
    prefill and decode to that many positions (0: full causal), as the
    reference's does. ``batch_size`` is stored as ``B`` and read by
    nothing, as in the reference, which serves B=1 too. ``jit=False``
    runs the decode step eagerly, as the reference's server would
    without ``jax.jit``."""

    def __init__(self, cfg, params, *, batch_size: int = 1,
                 cache_len: int = 256, window: int = 0,
                 enable_prefix_cache: bool = True, jit: bool = True,
                 device="cuda"):
        self.device = _device.resolve(device)
        where = params["embed"]["emb"].device
        if where.type != self.device.type:
            raise ValueError(f"params live on {where}, the server on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.B = batch_size
        self.cache_len = cache_len
        self.window = window
        self.enable_prefix_cache = enable_prefix_cache
        # (prompt hash, length, cond hash) -> (cache snapshot, length)
        self.prefix_cache: Dict[Tuple[str, int, str], Tuple[dict, int]] = {}
        # each stored prompt's last logits, under its entry's key
        self.prefix_logits: Dict[Tuple[str, int, str], torch.Tensor] = {}
        self.stats = {"prefix_hits": 0, "prefix_misses": 0,
                      "prefill_tokens": 0, "decode_steps": 0}
        self._prefill = functools.partial(T.prefill, cfg=cfg,
                                          cache_len=cache_len,
                                          window_attn=window)
        # the decode step's static state: the cache it writes in place and
        # the token and position it reads
        dev = self.device
        self._state = {
            "params": params,
            "cache": T.init_cache(cfg, 1, cache_len, device=dev),
            "tokens": torch.zeros((1, 1) + ((cfg.n_codebooks,)
                                            if cfg.n_codebooks > 1 else ()),
                                  dtype=torch.int64, device=dev),
            "t": torch.zeros((), dtype=torch.int32, device=dev),
            "window": window}
        step = functools.partial(_decode_logits, cfg=cfg)
        self._decode_step = Graphed(step) if jit else step

    def compile_count(self) -> int:
        """Decode-step graphs: 1 once a step has run with ``jit``, else 0
        (prefill stays eager)."""
        return _compile_count(self._decode_step)

    def _decode(self, tokens, t: int):
        """Decode ``tokens`` (1, 1[, ncb]) at position ``t`` into the
        static cache; returns the logits."""
        state = self._state
        state["tokens"].copy_(tokens)
        state["t"].fill_(t)
        return self._decode_step(state)

    # -------------------------------------------------------------- util

    def _greedy(self, logits):
        return torch.argmax(logits, dim=-1)    # (B, 1[, ncb]); first maximum

    def _lookup_prefix(self, prompt: np.ndarray, ckey: str):
        """Longest stored prefix of ``prompt`` under the conditioning
        ``ckey`` (length quantized by whole prompts we've served)."""
        if not self.enable_prefix_cache:
            return None
        for plen in range(len(prompt), 0, -1):
            key = (_h(prompt[:plen]), plen, ckey)
            if key in self.prefix_cache:
                return plen, *self.prefix_cache[key]
        return None

    # ---------------------------------------------------------- serving

    def serve_one(self, req: Request) -> Result:
        """Single-request path (B=1) with prefix reuse."""
        prompt = np.asarray(req.prompt)
        want = 1 if self.cfg.n_codebooks == 1 else 2
        if prompt.ndim != want:
            raise ValueError(f"{self.cfg.name}: a prompt of {want} dims, "
                             f"(S,) or (S, ncb); got {prompt.shape}")
        cond = None if req.cond is None else np.asarray(req.cond)
        if cond is not None and cond.dtype == np.float64:
            cond = cond.astype(np.float32)  # as jnp.asarray takes it
        ckey = "none" if cond is None else _h(cond)   # the key's cond part
        S = len(prompt)
        hit = self._lookup_prefix(prompt, ckey)
        # the prompt goes to the device once; suffix tokens are views of it
        tokens = torch.as_tensor(prompt[None], device=self.device)

        cache = self._state["cache"]
        key = (_h(prompt), S, ckey)
        if hit is not None and hit[0] >= 1:
            plen, stored, _ = hit
            T.copy_cache(cache, stored)
            self.stats["prefix_hits"] += 1
            # feed the remaining prompt tokens through decode steps; a
            # prompt identical to the stored one takes its stored logits
            logits = self.prefix_logits[key] if plen == S else None
            for i in range(plen, S):
                logits = self._decode(tokens[:, i:i + 1], i)
            encoded = S - plen
        else:
            self.stats["prefix_misses"] += 1
            logits, fresh = self._prefill(
                self.params, tokens=tokens,
                cond=None if cond is None else torch.as_tensor(
                    cond[None], device=self.device))
            T.copy_cache(cache, fresh)
            del fresh                    # freed before the snapshot below
            encoded = S
        self.stats["prefill_tokens"] += encoded

        if self.enable_prefix_cache and encoded:
            # (an exact hit's entry is already this cache and these logits)
            self.prefix_cache[key] = (T.clone(cache), S)
            self.prefix_logits[key] = logits

        tok = self._greedy(logits)
        out = [tok[0, 0]]
        for step in range(1, req.max_new_tokens):
            logits = self._decode(tok, S + step - 1)
            tok = self._greedy(logits)
            self.stats["decode_steps"] += 1
            out.append(tok[0, 0])
            # the host reads a token only to test it for eos (in every
            # codebook)
            if req.eos_id is not None and bool((tok[0, 0] == req.eos_id).all()):
                break
        generated = torch.stack(out).cpu().numpy().astype(np.int32)
        return Result(rid=req.rid, tokens=generated,
                      prefix_hit=hit is not None, prefill_tokens=encoded)

    def serve(self, requests: List[Request]) -> List[Result]:
        return [self.serve_one(r) for r in requests]
