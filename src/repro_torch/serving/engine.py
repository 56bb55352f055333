"""LLM serving engine: prefill + greedy decode with prefix caching.

The LLM zoo's analogue of EMSServe's per-modality feature cache: a
request whose prompt extends an already-served prompt (a system prompt,
an earlier turn) reuses the stored decode cache instead of encoding the
prefix again. The same prefix hashing over the prompt's numpy bytes,
hit/miss/re-decode logic and ``stats`` as the reference
``repro.serving.engine.LLMServer``, for the cache families the port has
(GQA KV ring buffers, RWKV6 states).

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
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..graphs import Graphed
from ..graphs import compile_count as _compile_count
from ..models import transformer as T


@dataclass
class Request:
    rid: str
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
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
    returns the logits (B, 1, V)."""
    return T.decode_step(state["params"], cfg, state["tokens"],
                         state["cache"], state["t"])[0]


class LLMServer:
    """Greedy server for one architecture, one request at a time (B=1),
    on ``device`` (``cuda`` unless the caller asks for the CPU); ``params``
    must live there. The reference's ``batch_size``, ``window`` and
    ``cond`` inputs have no caller here and are left out (a windowed
    cache is ``transformer.decode_step(window_attn=...)``). ``jit=False``
    runs the decode step eagerly, as the reference's server would
    without ``jax.jit``."""

    def __init__(self, cfg, params, *, cache_len: int = 256,
                 enable_prefix_cache: bool = True, jit: bool = True,
                 device="cuda"):
        self.device = _device.resolve(device)
        where = params["embed"]["emb"].device
        if where.type != self.device.type:
            raise ValueError(f"params live on {where}, the server on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.cache_len = cache_len
        self.enable_prefix_cache = enable_prefix_cache
        self.prefix_cache: Dict[Tuple[str, int], Tuple[dict, int]] = {}
        self.stats = {"prefix_hits": 0, "prefix_misses": 0,
                      "prefill_tokens": 0, "decode_steps": 0}
        self._prefill = functools.partial(T.prefill, cfg=cfg,
                                          cache_len=cache_len)
        # the decode step's static state: the cache it writes in place and
        # the token and position it reads
        dev = self.device
        self._state = {
            "params": params,
            "cache": T.init_cache(cfg, 1, cache_len, device=dev),
            "tokens": torch.zeros((1, 1), dtype=torch.int64, device=dev),
            "t": torch.zeros((), dtype=torch.int32, device=dev)}
        step = functools.partial(_decode_logits, cfg=cfg)
        self._decode_step = Graphed(step) if jit else step

    def compile_count(self) -> int:
        """Decode-step graphs: 1 once a step has run with ``jit``, else 0
        (prefill stays eager)."""
        return _compile_count(self._decode_step)

    def _decode(self, tokens, t: int):
        """Decode ``tokens`` (1, 1) at position ``t`` into the static
        cache; returns the logits."""
        state = self._state
        state["tokens"].copy_(tokens)
        state["t"].fill_(t)
        return self._decode_step(state)

    # -------------------------------------------------------------- util

    def _greedy(self, logits):
        return torch.argmax(logits, dim=-1)            # (B, 1); first maximum

    def _lookup_prefix(self, prompt: np.ndarray):
        """Longest stored prefix of ``prompt`` (length quantized by whole
        prompts we've served)."""
        if not self.enable_prefix_cache:
            return None
        for plen in range(len(prompt), 0, -1):
            key = (_h(prompt[:plen]), plen)
            if key in self.prefix_cache:
                return plen, *self.prefix_cache[key]
        return None

    # ---------------------------------------------------------- serving

    def serve_one(self, req: Request) -> Result:
        """Single-request path (B=1) with prefix reuse."""
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1:
            raise NotImplementedError("multi-codebook prompts are not "
                                      "ported yet (ROADMAP item 11)")
        S = len(prompt)
        hit = self._lookup_prefix(prompt)
        # the prompt goes to the device once; suffix tokens are views of it
        tokens = torch.as_tensor(prompt[None], device=self.device)

        cache = self._state["cache"]
        if hit is not None and hit[0] >= 1:
            plen, stored, _ = hit
            T.copy_cache(cache, stored)
            self.stats["prefix_hits"] += 1
            # feed the remaining prompt tokens through decode steps
            logits = None
            for i in range(plen, S):
                logits = self._decode(tokens[:, i:i + 1], i)
            if logits is None:   # prompt identical to the cached prefix:
                # decode its last token again to get logits (cheap)
                logits = self._decode(tokens[:, S - 1:S], S - 1)
            encoded = S - plen
        else:
            self.stats["prefix_misses"] += 1
            logits, fresh = self._prefill(self.params, tokens=tokens)
            T.copy_cache(cache, fresh)
            del fresh                    # freed before the snapshot below
            encoded = S
        self.stats["prefill_tokens"] += encoded

        if self.enable_prefix_cache:
            self.prefix_cache[(_h(prompt), S)] = (T.clone(cache), S)

        tok = self._greedy(logits)
        out = [tok[0, 0]]
        for step in range(1, req.max_new_tokens):
            logits = self._decode(tok, S + step - 1)
            tok = self._greedy(logits)
            self.stats["decode_steps"] += 1
            out.append(tok[0, 0])
            # the host reads a token only to test it for eos
            if req.eos_id is not None and int(tok[0, 0]) == req.eos_id:
                break
        generated = torch.stack(out).cpu().numpy().astype(np.int32)
        return Result(rid=req.rid, tokens=generated,
                      prefix_hit=hit is not None, prefill_tokens=encoded)
