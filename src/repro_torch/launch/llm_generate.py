"""Prefix-cached LLM serving across the port's architecture zoo.

The paper's feature cache applied to autoregressive state: requests that
extend an already-served prompt reuse the stored decode cache (a KV ring
buffer or an RWKV state) instead of encoding the prefix again. Runs the
reduced variant of every ported architecture, one line each, on ``cuda``
unless ``--device cpu`` is given: mistral-nemo-12b, rwkv6-1.6b,
olmoe-1b-7b (MoE), codeqwen1.5-7b, nemotron-4-15b and qwen1.5-32b.

  python -m repro_torch.launch.llm_generate [--arch olmoe-1b-7b] [--device cpu]

A port of ``examples/llm_generate.py``; its third default family,
``deepseek-v3-671b`` (MLA latents), is not ported yet (ROADMAP item 11).
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
    except (NotImplementedError, KeyError) as e:
        raise SystemExit(f"llm_generate: {e.args[0]}") from None
    dev = _device.resolve(args.device)

    for arch, cfg in cfgs.items():
        # a CPU generator: the same weights on every device
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device=dev)
        srv = LLMServer(cfg, params, cache_len=96, device=dev)

        system_prompt = np.arange(1, 33, dtype=np.int32)     # shared prefix
        users = [np.array([40 + i, 50 + i], np.int32) for i in range(4)]

        t0 = time.perf_counter()
        srv.serve_one(Request("warm", system_prompt, max_new_tokens=1))
        results = [srv.serve_one(Request(f"u{i}",
                                         np.concatenate([system_prompt, u]),
                                         max_new_tokens=8))
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
