"""CLI: build the test spectrogram dataset on the GPU.

  python -m audiodenoiser_torch.cli.create_test_dataset \\
      --clean_dir ./data/test/clean --noise_dir ./data/test/noise \\
      --output_dir ./data/test_processed

Writes ``clean_{nt}.npy`` / ``noisy_{nt}.npy`` (N, n_fft/2+1, T) float32
magnitude stacks with a centred STFT (reverb wet level 0.35), plus the
``clean_audio.npy`` / ``noisy_audio_{nt}.npy`` waveform stacks unless
``--no_audio_artifacts``: the files ``cli.test`` reads. The flags are the
JAX CLI's, plus ``--device`` (default: the GPU).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Create the test spectrogram dataset")
    p.add_argument("--clean_dir", default="./data/test/clean")
    p.add_argument("--noise_dir", default="./data/test/noise")
    p.add_argument("--output_dir", default="./data/test_processed")
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--n_fft", type=int, default=512)
    p.add_argument("--hop_length", type=int, default=128)
    p.add_argument("--snr_db", type=float, default=8.0)
    p.add_argument("--reverb_wet_level", type=float, default=0.35)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--noise_types",
        nargs="+",
        default=["white", "urban", "reverb", "noise_cancellation"],
    )
    p.add_argument(
        "--no_audio_artifacts", action="store_true",
        help="skip the clean_audio.npy / noisy_audio_{nt}.npy waveform "
        "stacks (they let cli.test score a true SI-SDR and PESQ; the "
        "magnitude npys are always written).",
    )
    p.add_argument("--device", default=None, help="default: the GPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from audiodenoiser_torch.data.builders import build_test_dataset

    for nt in args.noise_types:
        print(f"Processing noise type: {nt}")
    build_test_dataset(
        clean_dir=args.clean_dir,
        noise_dir=args.noise_dir,
        output_dir=args.output_dir,
        sample_rate=args.sample_rate,
        n_fft=args.n_fft,
        hop_length=args.hop_length,
        snr_db=args.snr_db,
        noise_types=tuple(args.noise_types),
        reverb_wet_level=args.reverb_wet_level,
        seed=args.seed,
        save_audio=not args.no_audio_artifacts,
        device=args.device,
    )
    print("Test dataset creation is complete!")


if __name__ == "__main__":
    main()
