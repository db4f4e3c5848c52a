"""CLI: build the training spectrogram dataset on the GPU.

  python -m audiodenoiser_torch.cli.create_train_dataset \\
      --clean_dir ./data/train/clean --noise_dir ./data/train/noise \\
      --output_base ./data/train_processed

Writes ``{output_base}/{nt}/noisy_{nt}_chunk_{i}.npy`` and
``clean_{nt}_chunk_{i}.npy``, float32 (n_fft/2+1, T) magnitudes of an
uncentred STFT of each ``--chunk_seconds`` chunk (257 x 122 for 2 s at
8 kHz), and up to ``--num_debug_wav`` noisy wavs a noise type in
``--debug_dir``: what ``cli.train --pipeline npy`` reads. Clean files are
read through the native loader when it builds (``data/native.py``). The
flags are the JAX CLI's, plus ``--device`` (default: the GPU). On the GPU
the run ends with one ``[launches]`` JSON line, K1's launches by entry and
the chunks a second.
"""

from __future__ import annotations

import argparse
import json
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Create the training spectrogram dataset")
    p.add_argument("--clean_dir", default="./data/train/clean")
    p.add_argument("--noise_dir", default="./data/train/noise")
    p.add_argument("--output_base", default="./data/train_processed")
    p.add_argument("--debug_dir", default="./data/debug_audio")
    p.add_argument("--chunk_seconds", type=float, default=2.0)
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--n_fft", type=int, default=512)
    p.add_argument("--hop_length", type=int, default=128)
    p.add_argument("--snr_db", type=float, default=8.0)
    p.add_argument("--num_debug_wav", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--noise_types",
        nargs="+",
        default=["white", "urban", "reverb", "noise_cancellation"],
    )
    p.add_argument("--device_batch", type=int, default=256)
    p.add_argument("--device", default=None, help="default: the GPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from audiodenoiser_torch.data.builders import INGEST_COUNTS, build_train_dataset
    from audiodenoiser_torch.device import resolve_device
    from audiodenoiser_torch.ops.cuda import reset_launch_counts, stft_kernel, variant_launches

    device = resolve_device(args.device)
    reset_launch_counts()
    t0 = time.perf_counter()
    n = build_train_dataset(
        clean_dir=args.clean_dir,
        noise_dir=args.noise_dir,
        output_base=args.output_base,
        chunk_seconds=args.chunk_seconds,
        sample_rate=args.sample_rate,
        n_fft=args.n_fft,
        hop_length=args.hop_length,
        snr_db=args.snr_db,
        noise_types=tuple(args.noise_types),
        num_debug_wav=args.num_debug_wav,
        debug_dir=args.debug_dir,
        seed=args.seed,
        device_batch=args.device_batch,
        device=device,
    )
    wall = time.perf_counter() - t0
    print("Done! Saved 2D spectrograms in .npy for each noise type.")
    print(f"Debug WAVs are in: {args.debug_dir}")
    print("Check subdirectories in:", args.output_base, "for your spectrogram files.")
    print(f"Processed {n} chunks.")
    if device.type == "cuda":
        report = {"stft_kernel": variant_launches(stft_kernel), "chunks": n,
                  "wall_s": wall, "chunks_per_s": n / wall if wall > 0 else None,
                  "ingest": dict(INGEST_COUNTS)}
        print(f"[launches] {json.dumps(report)}", flush=True)
    return n


if __name__ == "__main__":
    main()
