"""CLI: train a denoiser on the GPU (port of ``cli/train.py``).

Usage:
  python -m audiodenoiser_torch.cli.train --base_dataset_path data/train_processed \
      --noise_type white --epochs 50 --export_dir ./saved_models
  python -m audiodenoiser_torch.cli.train --base_dataset_path data \
      --pipeline on_device --noise_type white --steps_per_epoch 500
  python -m audiodenoiser_torch.cli.train --base_dataset_path data \
      --model complex_mask --pipeline on_device --noise_type mixed --export_dir ./saved_models

``--pipeline npy`` reads prebuilt (noisy, clean) spectrogram pairs
(``cli.create_train_dataset``); ``--pipeline on_device`` synthesizes
noise and STFTs (the K1 kernel) on the card from a folder of clean wavs
(``clean/``, and ``noise/`` for urban or mixed), at ``--sample_rate`` in
windows of ``--chunk_seconds``. The best model is exported as
``unet_denoiser_{noise_type}.ckpt``; ``--model complex_mask``
(on-device pipeline only) trains the complex-mask U-Net on raw waveform
pairs (``train.mask``) and exports ``mask_denoiser_{noise_type}.ckpt``.
A ``.json`` sidecar records what a loader needs to rebuild the model
(the mask head; a rate other than 8 kHz). ``cli.serve`` and ``cli.test``
load either. The training extras are JAX's: ``--lr_schedule`` and
``--warmup_steps``, ``--grad_accum``, ``--ema_decay`` (also exports
``best_model_ema.ckpt``), ``--remat``, ``--resume`` with
``--ckpt_every``, and ``--profile_dir`` (a ``torch.profiler`` trace).
Flags of the JAX CLI that are not ported yet are accepted by name and stop
the run with the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

# flags of the JAX CLI that the port does not run yet, with the ROADMAP
# item that ports each
UNPORTED = {
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
    "distill_from": "ROADMAP A.10 (distillation)",
    "distill_weight": "ROADMAP A.10 (distillation)",
    "distill_features": "ROADMAP A.10 (distillation)",
}
_UNPORTED_SWITCHES = {"export_quantized", "attn_bottleneck", "s2d_stem", "fsdp"}
UNPORTED_MODELS = {"router": "ROADMAP A.10 (router)"}
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
    p.add_argument("--model", choices=["unet", "complex_mask", *UNPORTED_MODELS],
                   default="unet")
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps_per_epoch", type=int, default=None,
                   help="on_device pipeline: steps per epoch (default n_chunks/batch)")
    p.add_argument("--snr_min", type=float, default=None)
    p.add_argument("--snr_max", type=float, default=None)
    p.add_argument("--augment", action="store_true",
                   help="on_device pipeline: gain, polarity and time-shift augmentation")
    p.add_argument("--sample_rate", type=int, default=8000,
                   help="on_device pipeline: the audio rate (wavs are resampled on "
                   "ingest; n_fft 512 and hop 128 stay); recorded in the sidecar")
    p.add_argument("--chunk_seconds", type=float, default=2.0,
                   help="on_device pipeline: the training window in seconds")
    p.add_argument("--resume", action="store_true",
                   help="restore the run's checkpoints/train_state.pt and go on")
    p.add_argument("--lr_schedule", choices=["constant", "cosine"], default="constant",
                   help="constant (the reference's) or warm-up + cosine decay to 0 over "
                   "epochs x steps_per_epoch (with --grad_accum k a run covers 1/k of it, "
                   "as in the JAX CLI)")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear warm-up from 0 over this many updates")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over N micro-batches an optimizer update")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="track an EMA of the weights (e.g. 0.999), validate it each "
                   "epoch and export best_model_ema.ckpt beside the best model")
    p.add_argument("--remat", action="store_true",
                   help="recompute each U-Net block in the backward (less activation "
                   "memory, more compute)")
    p.add_argument("--ckpt_every", type=int, default=1,
                   help="write the resume state every N epochs (always after the last)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run into this directory")
    p.add_argument("--export_dir", type=str, default=None,
                   help="also export the best model here, as unet_denoiser_{noise_type}.ckpt "
                   "or (complex_mask) mask_denoiser_{noise_type}.ckpt, with its sidecar")
    p.add_argument("--si_sdr_weight", type=float, default=None,
                   help="complex_mask: weight of the negative-SI-SDR term (default 0.5; "
                   "0 keeps the spectral and waveform terms only)")
    p.add_argument("--si_sdr_clamp", type=float, default=30.0,
                   help="complex_mask: saturate each clip's SI-SDR reward at this many dB "
                   "(<= 0: no clamp), so clips the corruption left untouched add nothing")
    p.add_argument("--mask_bound", type=float, default=None,
                   help="complex_mask: tanh bound K of the mask (default 8 for "
                   "noise_cancellation and mixed, 2 otherwise)")
    p.add_argument("--mask_residual", choices=["on", "off"], default="on",
                   help="complex_mask: mask = identity + bounded deviation, with a "
                   "zero-initialised head (an exact pass-through at the start)")
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
    if args.model == "complex_mask" and args.pipeline != "on_device":
        raise SystemExit("--model complex_mask requires --pipeline on_device "
                         "(it trains on waveform pairs)")
    if args.noise_type == "mixed" and args.pipeline != "on_device":
        raise SystemExit("--noise_type mixed requires --pipeline on_device")
    if args.augment and args.pipeline != "on_device":
        raise SystemExit("--augment requires --pipeline on_device")
    if args.chunk_seconds != 2.0 and args.pipeline != "on_device":
        raise SystemExit("--chunk_seconds requires --pipeline on_device (the npy "
                         "pipeline's chunking happened at dataset build time)")
    if args.sample_rate != 8000 and args.pipeline != "on_device":
        raise SystemExit("--sample_rate requires --pipeline on_device (npy datasets "
                         "bake their rate in at featurize time: pass --sample_rate to "
                         "cli.create_train_dataset instead)")


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

    return train_batches, val_batches, max(1, -(-len(tr_idx) // args.batch_size))


def _on_device_batches(args, device):
    import torch

    from audiodenoiser_torch.data.builders import load_clean_chunks
    from audiodenoiser_torch.data.dataset import split_train_val
    from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
    from audiodenoiser_torch.data.wav_io import load_wav_list, read_wav

    if args.noise_type is None:
        raise SystemExit("--pipeline on_device requires --noise_type")
    sr, chunk = args.sample_rate, int(round(args.sample_rate * args.chunk_seconds))
    clean_dir = os.path.join(args.base_dataset_path, "clean")
    if not os.path.isdir(clean_dir):
        clean_dir = args.base_dataset_path
    chunks = load_clean_chunks(load_wav_list(clean_dir), sr, chunk)
    if args.subset_fraction < 1.0:
        chunks = chunks[: max(1, int(len(chunks) * args.subset_fraction))]
    if len(chunks) == 0:
        raise SystemExit(f"no {args.chunk_seconds:g} s clean chunks found in {clean_dir}")
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
                          augment=args.augment, sample_rate=sr, device=device, **snr)
    # validation stays at the reference's fixed SNR, un-augmented
    val_mixer = OnDeviceMixer(chunks[va_idx], args.noise_type, noise_bank=bank,
                              sample_rate=sr, device=device)
    n_steps = args.steps_per_epoch or max(1, len(mixer) // args.batch_size)
    val_steps = max(1, n_steps // 10)
    print(f"On-device pipeline: {len(mixer)} clean chunks, {n_steps} steps/epoch, "
          f"noise type {args.noise_type}.")
    # the mask family trains on the raw waveforms of the same draws
    attr = "sample_audio" if args.model == "complex_mask" else "sample"
    draw, val_draw = getattr(mixer, attr), getattr(val_mixer, attr)

    def train_batches(epoch):
        gen = torch.Generator(device=mixer.device).manual_seed(args.seed * 100_003 + epoch)
        for _ in range(n_steps):
            yield draw(gen, args.batch_size)

    def val_batches():
        gen = torch.Generator(device=mixer.device).manual_seed(10_000_019 + args.seed)
        for _ in range(val_steps):
            yield val_draw(gen, args.batch_size)

    return train_batches, val_batches, n_steps


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
    from audiodenoiser_torch.utils.profiling import maybe_trace

    device = resolve_device(args.device)
    cfg = FitConfig(run_name=args.run_name, output_path=args.output_path,
                    epochs=args.epochs, batch_size=args.batch_size,
                    learning_rate=args.learning_rate, seed=args.seed,
                    precision=args.precision, resume=args.resume,
                    lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
                    grad_accum=args.grad_accum, remat=args.remat,
                    ckpt_every=args.ckpt_every, ema_decay=args.ema_decay,
                    device=str(device), extra_config=vars(args))
    if args.pipeline == "npy":
        train_batches, val_batches, steps_per_epoch = _npy_batches(args)
    else:
        train_batches, val_batches, steps_per_epoch = _on_device_batches(args, device)
    if args.lr_schedule == "cosine":
        # the schedule counts updates and this counts steps, as the JAX CLI
        # does: with --grad_accum k a run covers 1/k of the decay
        cfg.total_steps = args.epochs * steps_per_epoch
    fit_kwargs, meta = {}, None
    if args.model == "complex_mask":
        fit_kwargs, meta = _mask_family(args, device, cfg)
    elif args.sample_rate != 8000:
        # what a loader needs to rebuild the magnitude model at this rate
        meta = {"width_mult": 1.0, "sample_rate": args.sample_rate}
    with maybe_trace(args.profile_dir):
        result = fit(cfg, train_batches, val_batches, **fit_kwargs)

    run_meta = os.path.splitext(result["best_path"])[0] + ".json"
    if meta is not None and result["exported_best"]:
        # beside the run's checkpoint too, written only when this run
        # exported it: a resumed run that never beat the restored best must
        # not stamp the old weights with its own flags
        with open(run_meta, "w") as f:
            json.dump(meta, f)
    if meta is not None and result.get("exported_best_ema"):
        with open(os.path.splitext(result["best_ema_path"])[0] + ".json", "w") as f:
            json.dump(meta, f)
    if args.export_dir and args.noise_type:
        os.makedirs(args.export_dir, exist_ok=True)
        stem = "mask_denoiser" if args.model == "complex_mask" else "unet_denoiser"
        dst = os.path.join(args.export_dir, f"{stem}_{args.noise_type}.ckpt")
        if meta is not None:
            # the sidecar of the weights shipped: this run's if it exported,
            # else the run-dir sidecar of the earlier run's checkpoint; with
            # neither, their configuration is unknown and none is written
            payload = meta if result["exported_best"] else None
            if payload is None and os.path.exists(run_meta):
                with open(run_meta) as f:
                    payload = json.load(f)
            if payload is None:
                print("WARNING: exporting a checkpoint from an earlier run with no "
                      "recorded model sidecar; no sidecar is written (loaders will "
                      "use the defaults).")
            else:
                with open(os.path.splitext(dst)[0] + ".json", "w") as f:
                    json.dump(payload, f)
        if os.path.exists(result["best_path"]):
            shutil.copyfile(result["best_path"], dst)
            print(f"Exported best model to {dst}")
    return result


def _mask_family(args, device, cfg):
    """``fit``'s state factory and steps for ``--model complex_mask`` (with
    ``cfg``'s schedule and accumulation), and the sidecar that records the
    head and a rate other than 8 kHz, with the JAX CLI's per-type
    defaults: SI-SDR weight 0.5, clamp 30 dB, bound 8 where the stream
    holds noise_cancellation (undoing its 0.2x attenuation needs ~5x gain),
    else 2; a residual head starts as a zero-initialised pass-through."""
    import torch

    from audiodenoiser_torch.train import mask as mask_lib

    si_w = 0.5 if args.si_sdr_weight is None else args.si_sdr_weight
    si_clamp = args.si_sdr_clamp if args.si_sdr_clamp > 0 else None
    bound = args.mask_bound
    if bound is None:
        bound = 8.0 if args.noise_type in ("noise_cancellation", "mixed") else 2.0
    residual = args.mask_residual == "on"
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    meta = {"mask_bound": bound, "si_sdr_weight": si_w, "si_sdr_clamp": si_clamp,
            "residual": residual}
    if args.sample_rate != 8000:
        meta["sample_rate"] = args.sample_rate
    factory = lambda: mask_lib.create_mask_train_state(
        args.seed, mask_lib.ComplexMaskUNet(dtype=dtype, mask_bound=bound, residual=residual,
                                            zero_out_init=residual),
        learning_rate=args.learning_rate, device=device, schedule=cfg.lr_schedule,
        warmup_steps=cfg.warmup_steps, total_steps=cfg.total_steps,
        grad_accum=cfg.grad_accum)
    return {"state_factory": factory,
            "steps": mask_lib.make_mask_steps(si_w, si_clamp)}, meta


if __name__ == "__main__":
    main()
