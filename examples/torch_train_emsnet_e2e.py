"""End-to-end training driver on the PyTorch port: train EMSNet on the
synthetic NEMSIS-schema dataset — D1 2-modal pretraining then PMI
3-modal integration — evaluate all three tasks and checkpoint, through
``repro_torch.launch.train``.

With ``--text-encoder bertbase`` the backbone is the paper's ~110M
configuration; the default tinybert is the paper's on-device pick. The
port of ``examples/train_emsnet_e2e.py``; runs on the CUDA card unless
``--device cpu``. Arguments go to the launcher.

  PYTHONPATH=src python examples/torch_train_emsnet_e2e.py --steps 300 [--device cpu]
"""
import argparse
import sys

from repro_torch.launch import train as launcher


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--model") for a in argv):
        argv = ["--model", "emsnet"] + argv
    if not any(a.startswith("--out") for a in argv):
        argv += ["--out", "checkpoints/emsnet"]
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    known, _ = ap.parse_known_args(argv)
    launcher.main(argv)
    print(f"train_emsnet_e2e: EMSNet trained and checkpointed to "
          f"{known.out} on {known.device.split(':')[0]}")


if __name__ == "__main__":
    main()
