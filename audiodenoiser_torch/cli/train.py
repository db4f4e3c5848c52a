"""CLI: train the U-Net denoiser on the GPU (port of ``cli/train.py``).

Usage:
  python -m audiodenoiser_torch.cli.train --base_dataset_path data/train_processed \
      --noise_type white --epochs 50 --export_dir ./saved_models
  python -m audiodenoiser_torch.cli.train --base_dataset_path data \
      --pipeline on_device --noise_type white --steps_per_epoch 500

``--pipeline npy`` reads prebuilt (noisy, clean) spectrogram pairs;
``--pipeline on_device`` synthesizes noise and STFTs (the K1 kernel) on
the card from a folder of clean wavs (``clean/``, and ``noise/`` for
urban or mixed). The best model is exported as the reference-layout
``unet_denoiser_{noise_type}.pth`` that ``cli.serve`` loads. Flags of the
JAX CLI that are not ported yet are accepted by name and stop the run
with the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

# flags of the JAX CLI that the port does not run yet, with the ROADMAP
# item that ports each
UNPORTED = {
    "resume": "ROADMAP A.12 (orbax-style resume state)",
    "lr_schedule": "ROADMAP A.12 (cosine/warmup schedules)",
    "warmup_steps": "ROADMAP A.12 (cosine/warmup schedules)",
    "grad_accum": "ROADMAP A.12 (gradient accumulation)",
    "ema_decay": "ROADMAP A.12 (EMA weights)",
    "remat": "ROADMAP A.12 (remat)",
    "ckpt_every": "ROADMAP A.12 (orbax-style resume state)",
    "export_quantized": "ROADMAP A.10 (int8 export)",
    "width_mult": "ROADMAP A.10 (width_mult)",
    "attn_bottleneck": "ROADMAP A.10 (attention bottleneck)",
    "s2d_stem": "ROADMAP A.10 (s2d stem)",
    "s2d_skip": "ROADMAP A.10 (s2d stem)",
    "model_parallel": "ROADMAP A.11 (parallelism)",
    "mesh": "ROADMAP A.11 (parallelism)",
    "fsdp": "ROADMAP A.11 (parallelism)",
    "pp_stages": "ROADMAP A.11 (parallelism)",
    "pp_microbatches": "ROADMAP A.11 (parallelism)",
    "sample_rate": "ROADMAP A.6 (on-device pipeline at other rates)",
    "chunk_seconds": "ROADMAP A.6 (on-device pipeline at other window lengths)",
    "si_sdr_weight": "ROADMAP A.8 (complex-mask family)",
    "si_sdr_clamp": "ROADMAP A.8 (complex-mask family)",
    "mask_bound": "ROADMAP A.8 (complex-mask family)",
    "mask_residual": "ROADMAP A.8 (complex-mask family)",
    "distill_from": "ROADMAP A.10 (distillation)",
    "distill_weight": "ROADMAP A.10 (distillation)",
    "distill_features": "ROADMAP A.10 (distillation)",
    "profile_dir": "ROADMAP A.12 (profiler traces from the CLI)",
}
_UNPORTED_SWITCHES = {"resume", "remat", "export_quantized", "attn_bottleneck",
                      "s2d_stem", "fsdp"}
UNPORTED_MODELS = {"complex_mask": "ROADMAP A.8 (complex-mask family)",
                   "router": "ROADMAP A.10 (router)"}
NOISE_TYPES = ("white", "urban", "reverb", "noise_cancellation")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="U-NET Audio Denoising Training Script (CUDA)")
    p.add_argument("--run_name", type=str, default=f"UNET_Run_{int(time.time())}")
    p.add_argument("--base_dataset_path", type=str, required=True,
                   help="a folder of clean/noisy .npy pairs, a train_processed root "
                   "with per-noise-type subfolders, or (with --pipeline on_device) "
                   "a folder of clean (and noise) wavs")
    p.add_argument("--output_path", type=str, default="./training_outputs_unet")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--num_workers", type=int, default=4, help="host prefetch depth")
    p.add_argument("--subset_fraction", type=float, default=1.0)
    p.add_argument("--noise_type", type=str, default=None,
                   choices=[*NOISE_TYPES, "all", "mixed"],
                   help="'all' trains the four specialists in turn; 'mixed' one "
                   "universal model (needs --pipeline on_device)")
    p.add_argument("--pipeline", choices=["npy", "on_device"], default="npy")
    p.add_argument("--model", choices=["unet", *UNPORTED_MODELS], default="unet")
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps_per_epoch", type=int, default=None,
                   help="on_device pipeline: steps per epoch (default n_chunks/batch)")
    p.add_argument("--snr_min", type=float, default=None)
    p.add_argument("--snr_max", type=float, default=None)
    p.add_argument("--augment", action="store_true",
                   help="on_device pipeline: gain, polarity and time-shift augmentation")
    p.add_argument("--export_dir", type=str, default=None,
                   help="also export the best model as unet_denoiser_{noise_type}.pth here")
    p.add_argument("--device", type=str, default=None, help="default: the GPU")
    for name in UNPORTED:
        if name in _UNPORTED_SWITCHES:
            p.add_argument(f"--{name}", action="store_true", default=argparse.SUPPRESS)
        else:
            p.add_argument(f"--{name}", default=argparse.SUPPRESS)
    return p.parse_args(argv)


def _resolve_npy_dir(base: str, noise_type: str | None) -> str:
    """The folder of .npy pairs, after the reference's path conventions."""
    candidates = []
    if noise_type:
        candidates += [os.path.join(base, noise_type),
                       os.path.join(base, "train_processed", noise_type),
                       os.path.join(base, "train", noise_type)]
    candidates += [base, os.path.join(base, "train")]
    for c in candidates:
        if os.path.isdir(c) and any(f.endswith(".npy") for f in os.listdir(c)):
            return c
    raise FileNotFoundError(f"no .npy spectrogram pairs found under {base!r} "
                            f"(noise_type={noise_type!r})")


def _check_ported(args) -> None:
    for name, item in UNPORTED.items():
        if hasattr(args, name):
            raise SystemExit(f"--{name} is not ported yet: {item}")
    if args.model in UNPORTED_MODELS:
        raise SystemExit(f"--model {args.model} is not ported yet: "
                         f"{UNPORTED_MODELS[args.model]}")
    if args.noise_type == "mixed" and args.pipeline != "on_device":
        raise SystemExit("--noise_type mixed requires --pipeline on_device")
    if args.augment and args.pipeline != "on_device":
        raise SystemExit("--augment requires --pipeline on_device")


def _npy_batches(args):
    from audiodenoiser_torch.data.dataset import SpectrogramPairs, batches, split_train_val

    ds = SpectrogramPairs(_resolve_npy_dir(args.base_dataset_path, args.noise_type),
                          subset_fraction=args.subset_fraction, seed=args.seed)
    tr_idx, va_idx = split_train_val(len(ds), 0.1, seed=args.seed)
    print(f"Dataset split: {len(tr_idx)} training samples, "
          f"{len(va_idx)} validation samples.")

    def train_batches(epoch):
        return batches(ds, tr_idx, args.batch_size, shuffle=True,
                       seed=args.seed + epoch, prefetch=max(1, args.num_workers))

    def val_batches():
        return batches(ds, va_idx, args.batch_size, shuffle=False)

    return train_batches, val_batches


def _on_device_batches(args, device):
    import torch

    from audiodenoiser_torch.data.builders import load_clean_chunks
    from audiodenoiser_torch.data.dataset import split_train_val
    from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
    from audiodenoiser_torch.data.wav_io import load_wav_list, read_wav

    if args.noise_type is None:
        raise SystemExit("--pipeline on_device requires --noise_type")
    sr, chunk = 8000, 16000
    clean_dir = os.path.join(args.base_dataset_path, "clean")
    if not os.path.isdir(clean_dir):
        clean_dir = args.base_dataset_path
    chunks = load_clean_chunks(load_wav_list(clean_dir), sr, chunk)
    if args.subset_fraction < 1.0:
        chunks = chunks[: max(1, int(len(chunks) * args.subset_fraction))]
    if len(chunks) == 0:
        raise SystemExit(f"no 2 s clean chunks found in {clean_dir}")
    bank = None
    if args.noise_type in ("urban", "mixed"):
        noise_dir = os.path.join(args.base_dataset_path, "noise")
        clips = [read_wav(f, sample_rate=sr)[0] for f in load_wav_list(noise_dir)]
        bank = NoiseBank(clips, target_len=chunk, device=device)
    # a 90/10 split over the clean chunks: validation draws from chunks
    # training never sees
    tr_idx, va_idx = split_train_val(len(chunks), 0.1, seed=args.seed)
    if len(va_idx) == 0:
        va_idx = tr_idx[:1]
    snr = {}
    if args.snr_min is not None and args.snr_max is not None:
        snr["snr_db"] = (args.snr_min, args.snr_max)
    mixer = OnDeviceMixer(chunks[tr_idx], args.noise_type, noise_bank=bank,
                          augment=args.augment, device=device, **snr)
    # validation stays at the reference's fixed SNR, un-augmented
    val_mixer = OnDeviceMixer(chunks[va_idx], args.noise_type, noise_bank=bank,
                              device=device)
    n_steps = args.steps_per_epoch or max(1, len(mixer) // args.batch_size)
    val_steps = max(1, n_steps // 10)
    print(f"On-device pipeline: {len(mixer)} clean chunks, {n_steps} steps/epoch, "
          f"noise type {args.noise_type}.")

    def train_batches(epoch):
        gen = torch.Generator(device=mixer.device).manual_seed(args.seed * 100_003 + epoch)
        for _ in range(n_steps):
            yield mixer.sample(gen, args.batch_size)

    def val_batches():
        gen = torch.Generator(device=mixer.device).manual_seed(10_000_019 + args.seed)
        for _ in range(val_steps):
            yield val_mixer.sample(gen, args.batch_size)

    return train_batches, val_batches


def main(argv=None):
    args = parse_args(argv)
    _check_ported(args)
    if args.noise_type == "all":  # the four specialists, one run each
        argv = list(argv) if argv is not None else __import__("sys").argv[1:]
        results = {}
        for nt in NOISE_TYPES:
            sub = [nt if prev == "--noise_type" else a
                   for prev, a in zip([None] + argv[:-1], argv)]
            sub = [a.replace("--noise_type=all", f"--noise_type={nt}") for a in sub]
            results[nt] = main(sub + ["--run_name", f"{args.run_name}_{nt}"])
        return results

    from audiodenoiser_torch.device import resolve_device
    from audiodenoiser_torch.train.loop import FitConfig, fit

    device = resolve_device(args.device)
    cfg = FitConfig(run_name=args.run_name, output_path=args.output_path,
                    epochs=args.epochs, batch_size=args.batch_size,
                    learning_rate=args.learning_rate, seed=args.seed,
                    precision=args.precision, device=str(device),
                    extra_config=vars(args))
    if args.pipeline == "npy":
        train_batches, val_batches = _npy_batches(args)
    else:
        train_batches, val_batches = _on_device_batches(args, device)
    result = fit(cfg, train_batches, val_batches)

    if args.export_dir and args.noise_type and os.path.exists(result["best_path"]):
        os.makedirs(args.export_dir, exist_ok=True)
        dst = os.path.join(args.export_dir, f"unet_denoiser_{args.noise_type}.pth")
        shutil.copyfile(result["best_path"], dst)
        print(f"Exported best model to {dst}")
    return result


if __name__ == "__main__":
    main()
