"""CLI: convert reference PyTorch ``.pth`` checkpoints to ``.ckpt`` exports.

  python -m audiodenoiser_torch.cli.import_checkpoint model.pth model.ckpt
  python -m audiodenoiser_torch.cli.import_checkpoint --saved_models_dir ./saved_models

The second form converts every ``unet_denoiser_*.pth`` in the folder to a
``.ckpt`` beside it; ``--quantize`` stores the conv kernels as per-channel
int8 (``int8-v1``, about 4x smaller). The bytes are the ones the JAX
package's CLI writes for the same file.
"""

from __future__ import annotations

import argparse

from audiodenoiser_torch.cli.export_checkpoint import conversion_jobs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convert .pth checkpoints to .ckpt")
    p.add_argument("src", nargs="?", help="source .pth file")
    p.add_argument("dst", nargs="?", help="destination .ckpt file")
    p.add_argument("--saved_models_dir", default=None,
                   help="convert every unet_denoiser_*.pth in this directory in place")
    p.add_argument("--quantize", action="store_true",
                   help="store conv kernels as per-channel int8 (~4x smaller export)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from audiodenoiser_torch.train.checkpoints import export_model
    from audiodenoiser_torch.train.torch_import import load_pth

    jobs = conversion_jobs(args, ".pth", ".ckpt")
    for src, dst in jobs:
        payload = load_pth(src)
        export_model(dst, payload["params"], payload["batch_stats"], quantize=args.quantize)
        print(f"converted {src} -> {dst}" + (" (int8)" if args.quantize else ""))
    if not jobs:
        print("nothing to convert")


if __name__ == "__main__":
    main()
