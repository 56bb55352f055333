"""Prefix-cached LLM serving across the architecture zoo, on the PyTorch
port.

The paper's feature cache, applied to autoregressive state: requests
that extend an already-served prompt reuse the stored decode cache (KV
ring buffer / RWKV state / MLA latents) instead of encoding the prefix
again. Runs the reduced variants of the reference example's three cache
families, mistral-nemo-12b, rwkv6-1.6b and deepseek-v3-671b, one line
each, through ``repro_torch.launch.llm_generate``. The port of
``examples/llm_generate.py``; runs on the CUDA card unless
``--device cpu``.

  PYTHONPATH=src python examples/torch_llm_generate.py [--arch rwkv6-1.6b] [--device cpu]
"""
import argparse

from repro_torch.launch import llm_generate

FAMILIES = ("mistral-nemo-12b", "rwkv6-1.6b", "deepseek-v3-671b")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="single arch id; default runs three cache families")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    for arch in [args.arch] if args.arch else FAMILIES:
        llm_generate.main(["--arch", arch, "--device", args.device])


if __name__ == "__main__":
    main()
