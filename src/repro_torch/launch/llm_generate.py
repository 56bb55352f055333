"""Prefix-cached LLM serving across the port's architecture zoo.

The paper's feature cache applied to autoregressive state: requests that
extend an already-served prompt reuse the stored decode cache (a KV ring
buffer, MLA latents, a Mamba or RWKV state, or cross-attention keys and
values) instead of encoding the prefix again. Runs the reduced variant
of every architecture, one line each, on ``cuda`` unless ``--device
cpu`` is given: mistral-nemo-12b, rwkv6-1.6b, olmoe-1b-7b (MoE),
codeqwen1.5-7b, nemotron-4-15b, qwen1.5-32b, jamba-v0.1-52b (Mamba +
attention), deepseek-v3-671b (MLA + MoE), llama-3.2-vision-11b (gated
cross-attention over a stub image) and musicgen-large (4 codebooks,
conditioned on stub text features). A conditioned arch's requests carry
one stub input (cond_seq_len, cond_dim) drawn from a numpy generator
with seed 0; a multi-codebook arch's prompts hold the same token values
in each codebook's column, offset by the codebook.

  python -m repro_torch.launch.llm_generate [--arch olmoe-1b-7b] [--device cpu]

``examples/torch_llm_generate.py`` runs the reference example's three
cache families through this launcher.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import device as _device
from ..configs import ARCHS, get_config, reduced
from ..models import transformer as T
from ..serving.engine import LLMServer, Request


def codebooks(cfg, tokens):
    """``tokens`` (S,) as a prompt of ``cfg``: itself, or (S, ncb) with
    codebook c's column offset by c."""
    if cfg.n_codebooks == 1:
        return tokens
    return np.stack([(tokens + c) % cfg.vocab_size
                     for c in range(cfg.n_codebooks)], axis=-1).astype(np.int32)


def stub_cond(cfg, seed=0):
    """The stub frontend's features (cond_seq_len, cond_dim) of a
    conditioned arch, float32 from a numpy generator with ``seed``; else
    None."""
    if not cfg.cond_dim:
        return None
    return np.random.default_rng(seed).normal(
        size=(cfg.cond_seq_len, cfg.cond_dim)).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help=f"single arch id; default runs {', '.join(ARCHS)}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCHS)
    try:
        cfgs = {arch: reduced(get_config(arch)) for arch in archs}
    except KeyError as e:
        raise SystemExit(f"llm_generate: {e.args[0]}") from None
    dev = _device.resolve(args.device)

    for arch, cfg in cfgs.items():
        # a CPU generator: the same weights on every device
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device=dev)
        srv = LLMServer(cfg, params, cache_len=96, device=dev)

        system_prompt = codebooks(cfg, np.arange(1, 33, dtype=np.int32))
        users = [codebooks(cfg, np.array([40 + i, 50 + i], np.int32))
                 for i in range(4)]
        cond = stub_cond(cfg)

        t0 = time.perf_counter()
        srv.serve_one(Request("warm", system_prompt, max_new_tokens=1,
                              cond=cond))
        results = [srv.serve_one(Request(f"u{i}",
                                         np.concatenate([system_prompt, u]),
                                         max_new_tokens=8, cond=cond))
                   for i, u in enumerate(users)]
        dt = time.perf_counter() - t0

        hits = sum(r.prefix_hit for r in results)
        encoded = sum(r.prefill_tokens for r in results)
        naive = sum(len(system_prompt) + len(u) for u in users)
        print(f"{arch:22s} ({cfg.arch_type:6s}): {hits}/4 prefix hits, "
              f"encoded {encoded} vs {naive} prompt tokens "
              f"({naive / max(encoded, 1):.1f}x fewer), {dt:.2f}s, "
              f"first completion: {results[0].tokens[:6].tolist()}, "
              f"decode CUDA graphs {srv.compile_count()} on {dev.type}",
              flush=True)


if __name__ == "__main__":
    main()
