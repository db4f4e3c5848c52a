"""CLI: convert ``.ckpt`` exports to reference PyTorch ``.pth`` files.

  python -m audiodenoiser_torch.cli.export_checkpoint model.ckpt model.pth
  python -m audiodenoiser_torch.cli.export_checkpoint --saved_models_dir ./saved_models

The second form converts every ``unet_denoiser_*.ckpt`` in the folder to a
``.pth`` beside it. An int8 export is written dequantized. The inverse is
``cli.import_checkpoint``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convert .ckpt checkpoints to .pth")
    p.add_argument("src", nargs="?", help="source .ckpt file")
    p.add_argument("dst", nargs="?", help="destination .pth file")
    p.add_argument("--saved_models_dir", default=None,
                   help="convert every unet_denoiser_*.ckpt in this directory in place")
    return p.parse_args(argv)


def conversion_jobs(args, src_ext: str, dst_ext: str) -> list[tuple[str, str]]:
    """(src, dst) pairs: ``SRC DST``, or each ``unet_denoiser_*{src_ext}``
    of ``--saved_models_dir`` beside its ``{dst_ext}``."""
    if args.saved_models_dir:
        return [(os.path.join(args.saved_models_dir, f),
                 os.path.join(args.saved_models_dir, f[: -len(src_ext)] + dst_ext))
                for f in sorted(os.listdir(args.saved_models_dir))
                if f.startswith("unet_denoiser_") and f.endswith(src_ext)]
    if args.src and args.dst:
        return [(args.src, args.dst)]
    raise SystemExit("provide SRC DST or --saved_models_dir")


def main(argv=None):
    args = parse_args(argv)
    from audiodenoiser_torch.train.checkpoints import load_exported
    from audiodenoiser_torch.train.torch_export import save_pth

    jobs = conversion_jobs(args, ".ckpt", ".pth")
    for src, dst in jobs:
        save_pth(load_exported(src), dst)
        print(f"converted {src} -> {dst}")
    if not jobs:
        print("nothing to convert")


if __name__ == "__main__":
    main()
