"""CLI: train a denoiser on the GPU (port of ``cli/train.py``).

Usage:
  python -m audiodenoiser_torch.cli.train --base_dataset_path data/train_processed \
      --noise_type white --epochs 50 --export_dir ./saved_models
  python -m audiodenoiser_torch.cli.train --base_dataset_path data \
      --pipeline on_device --noise_type white --steps_per_epoch 500
  python -m audiodenoiser_torch.cli.train --base_dataset_path data \
      --model complex_mask --pipeline on_device --noise_type mixed --export_dir ./saved_models
  python -m audiodenoiser_torch.cli.train --base_dataset_path data \
      --model router --pipeline on_device --noise_type mixed --export_dir ./saved_models
  python -m audiodenoiser_torch.cli.train --base_dataset_path data \
      --model complex_mask --pipeline on_device --noise_type mixed --width_mult 0.25 \
      --distill_from saved_models/mask_denoiser_mixed.ckpt --distill_features 1.0 \
      --export_dir ./students --export_quantized
  python -m audiodenoiser_torch.cli.train --base_dataset_path data \
      --model complex_mask --pipeline on_device --noise_type mixed --s2d_stem --s2d_skip 16 \
      --attn_bottleneck --export_dir ./saved_models

``--pipeline npy`` reads prebuilt (noisy, clean) spectrogram pairs
(``cli.create_train_dataset``); ``--pipeline on_device`` synthesizes
noise and STFTs (the K1 kernel) on the card from a folder of clean wavs
(``clean/``, and ``noise/`` for urban or mixed), at ``--sample_rate`` in
windows of ``--chunk_seconds``. The best model is exported as
``unet_denoiser_{noise_type}.ckpt``; ``--model complex_mask``
(on-device pipeline only) trains the complex-mask U-Net on raw waveform
pairs (``train.mask``) and exports ``mask_denoiser_{noise_type}.ckpt``.
A ``.json`` sidecar records what a loader needs to rebuild the model
(the mask head, ``--width_mult``, the U-Net variant, a rate other than
8 kHz). ``cli.serve`` and ``cli.test``
load either. ``--model router`` (``--pipeline on_device --noise_type
mixed``) trains the noise router on the labelled mixed stream for
``epochs x steps_per_epoch`` steps and exports ``noise_router.ckpt`` with
a sidecar recording its training window, the router of ``--auto_route``. The training extras are JAX's: ``--lr_schedule`` and
``--warmup_steps``, ``--grad_accum``, ``--ema_decay`` (also exports
``best_model_ema.ckpt``), ``--remat``, ``--resume`` with
``--ckpt_every``, and ``--profile_dir`` (a ``torch.profiler`` trace).
``--width_mult`` trains a compact student of either family; a mask
student may learn from a frozen teacher export (``--distill_from``, the
masked-spectrum term ``--distill_weight`` and the bottleneck attention
term ``--distill_features``); ``--export_quantized`` ships the best model
with int8 kernels. The U-Net variants of either family are JAX's:
``--s2d_stem`` (space-to-depth stem, a half-resolution pyramid),
``--s2d_skip K`` (with it, the full-resolution refinement path) and
``--attn_bottleneck`` (self-attention after the bottleneck). On the GPU
the run ends with one ``[launches]`` JSON line, each kernel's launches by
variant. ``--mesh``, ``--model_parallel`` and ``--fsdp`` train on a
('data', 'model') device mesh (``parallel.make_mesh``): the batch over
``data``, the wide convs over ``model``, with ``--fsdp`` their kernels and
AdamW moments over ``data`` too. Launch one rank per card:

  torchrun --nproc_per_node 4 -m audiodenoiser_torch.cli.train \
      --base_dataset_path data --noise_type white --mesh on --model_parallel 2

(rank 0 writes the logs and exports); ``--mesh on`` in one process runs a
world-size-1 mesh. ``--pp_stages S`` trains the magnitude U-Net with the
1F1B pipeline (``parallel.pipeline_train``): the block sequence cut into S
stages, on the process's first S cards (S must divide the visible cards;
with ``--device cpu`` every stage is the CPU), each batch in
``--pp_microbatches`` microbatches, every rank of the process group a data
replica running its own pipeline, validation through the pipelined
forward, the best model exported in the standard ``.ckpt`` format and the
resume state in ``checkpoints/pp_train_state.pt``. It runs JAX's
constant-rate AdamW path and refuses what JAX's refuses.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

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
    p.add_argument("--model", choices=["unet", "complex_mask", "router"], default="unet",
                   help="router: the noise-type classifier of the self-routing "
                   "deployment (needs --pipeline on_device --noise_type mixed)")
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
    p.add_argument("--width_mult", type=float, default=1.0,
                   help="channel-width multiplier of a compact student (0.5 -> 7.8M "
                   "parameters, 0.25 -> 2.0M; widths round to multiples of 8); recorded "
                   "in the sidecar. 1.0: the 31M-parameter U-Net")
    p.add_argument("--distill_from", type=str, default=None,
                   help="complex_mask: a frozen teacher export (mask_denoiser_*.ckpt, its "
                   "sidecar rebuilds it) whose masked spectrum the student matches")
    p.add_argument("--distill_weight", type=float, default=0.5,
                   help="weight of the teacher-matching term (with --distill_from)")
    p.add_argument("--distill_features", type=float, default=0.0,
                   help="weight of the attention-transfer term at the bottleneck (with "
                   "--distill_from); 0 leaves it out")
    p.add_argument("--export_quantized", action="store_true",
                   help="export the best model to --export_dir with int8 conv kernels")
    p.add_argument("--attn_bottleneck", action="store_true",
                   help="one residual self-attention block after the U-Net bottleneck "
                   "(clip-wide context); recorded in the sidecar")
    p.add_argument("--s2d_stem", action="store_true",
                   help="space-to-depth stem + sub-pixel head: the whole pyramid at half "
                   "resolution; recorded in the sidecar")
    p.add_argument("--s2d_skip", type=int, default=0,
                   help="with --s2d_stem: width of a full-resolution refinement path (one "
                   "BN-free Conv3x3 -> ReLU on the input, a final Conv3x3); 0 disables; "
                   "recorded in the sidecar")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="channel-TP degree on the device mesh; the data axis takes the "
                   "remaining ranks (world size / model_parallel)")
    p.add_argument("--mesh", choices=["auto", "on", "off"], default="auto",
                   help="auto: shard over a ('data','model') mesh iff the process group "
                   "has more than one rank; on/off force it (on in one process: a "
                   "world-size-1 mesh)")
    p.add_argument("--fsdp", action="store_true",
                   help="FSDP layout: also shard the wide conv kernels and their AdamW "
                   "moments over the data axis (FSDP2)")
    p.add_argument("--pp_stages", type=int, default=0,
                   help="pipeline-parallel training: split the U-Net block sequence into N "
                   "stages on the process's first N cards and train with the 1F1B schedule "
                   "(parallel/pipeline_train.py); every rank is a data replica. Constant LR "
                   "only; magnitude (unet) family")
    p.add_argument("--pp_microbatches", type=int, default=4,
                   help="microbatches a 1F1B step (batch_size must divide by "
                   "pp_microbatches * data replicas)")
    p.add_argument("--device", type=str, default=None, help="default: the GPU")
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


def _check_flags(args) -> None:
    if args.s2d_skip and not args.s2d_stem:
        raise SystemExit("--s2d_skip requires --s2d_stem (it refines the "
                         "sub-pixel head)")
    if args.model == "complex_mask" and args.pipeline != "on_device":
        raise SystemExit("--model complex_mask requires --pipeline on_device "
                         "(it trains on waveform pairs)")
    if args.distill_from and args.model != "complex_mask":
        raise SystemExit("--distill_from supports --model complex_mask only "
                         "(the teacher term matches masked spectra)")
    if args.distill_features and not args.distill_from:
        raise SystemExit("--distill_features requires --distill_from "
                         "(there is no teacher to match without it)")
    if args.model == "router" and (args.pipeline != "on_device" or args.noise_type != "mixed"):
        raise SystemExit("--model router requires --pipeline on_device --noise_type mixed "
                         "(labels come from the per-example corruption draw)")
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


def _mixers(args, device):
    """The training and validation mixers of the on-device pipeline."""
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
    return mixer, val_mixer


def _on_device_batches(args, device):
    import torch

    mixer, val_mixer = _mixers(args, device)
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
    _check_flags(args)
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
    from audiodenoiser_torch.parallel.distributed import local_device, maybe_initialize
    from audiodenoiser_torch.train.loop import FitConfig, fit
    from audiodenoiser_torch.utils.profiling import maybe_trace

    maybe_initialize(args.device)  # a no-op without a launcher
    device = resolve_device(local_device(args.device))
    if args.model == "router":
        return _train_router(args, device)
    cfg = FitConfig(run_name=args.run_name, output_path=args.output_path,
                    epochs=args.epochs, batch_size=args.batch_size,
                    learning_rate=args.learning_rate, seed=args.seed,
                    precision=args.precision, resume=args.resume,
                    lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
                    grad_accum=args.grad_accum, remat=args.remat,
                    ckpt_every=args.ckpt_every, ema_decay=args.ema_decay,
                    width_mult=args.width_mult, attn_bottleneck=args.attn_bottleneck,
                    s2d_stem=args.s2d_stem, s2d_skip=args.s2d_skip,
                    model_parallel=args.model_parallel,
                    use_mesh={"auto": None, "on": True, "off": False}[args.mesh],
                    fsdp=args.fsdp, device=str(device), extra_config=vars(args))
    if args.pipeline == "npy":
        train_batches, val_batches, steps_per_epoch = _npy_batches(args)
    else:
        train_batches, val_batches, steps_per_epoch = _on_device_batches(args, device)
    fit_kwargs, meta = {}, None
    if args.pp_stages:
        _check_pp(args)
    elif args.lr_schedule == "cosine":
        # the schedule counts updates and this counts steps, as the JAX CLI
        # does: with --grad_accum k a run covers 1/k of the decay
        cfg.total_steps = args.epochs * steps_per_epoch
    if args.model == "complex_mask":
        fit_kwargs, meta = _mask_family(args, device, cfg)
    elif (args.width_mult != 1.0 or args.attn_bottleneck or args.s2d_stem
          or args.sample_rate != 8000):
        # what a loader needs to rebuild the magnitude model
        meta = {"width_mult": args.width_mult, **_variant_meta(args)}
        if args.sample_rate != 8000:
            meta["sample_rate"] = args.sample_rate
    from audiodenoiser_torch.ops.cuda import KERNELS, reset_launch_counts, variant_launches

    reset_launch_counts()  # this run's launches alone (--noise_type all runs four)
    with maybe_trace(args.profile_dir):
        if args.pp_stages:
            result = _train_pp(args, cfg, train_batches, val_batches, device)
        else:
            result = fit(cfg, train_batches, val_batches, **fit_kwargs)
    if device.type == "cuda":
        counts = {k.__name__: {"launches": k.launches, **variant_launches(k)}
                  for k in KERNELS}
        print(f"[launches] {json.dumps(counts)}", flush=True)
    from audiodenoiser_torch.parallel.distributed import is_primary

    if not is_primary():  # rank 0 writes the sidecars and the export
        return result
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
            if args.export_quantized:
                from audiodenoiser_torch.train.checkpoints import export_model, load_exported

                payload = load_exported(result["best_path"])
                export_model(dst, payload["params"], payload["batch_stats"], quantize=True)
                print(f"Exported int8-quantized best model to {dst}")
            else:
                shutil.copyfile(result["best_path"], dst)
                print(f"Exported best model to {dst}")
    return result


def _variant_meta(args) -> dict:
    """The sidecar keys of the U-Net variant, JAX's: set switches only."""
    meta = {}
    if args.attn_bottleneck:
        meta["attn_bottleneck"] = True
    if args.s2d_stem:
        meta["s2d_stem"] = True
    if args.s2d_skip:
        meta["s2d_skip"] = args.s2d_skip
    return meta


def _train_router(args, device):
    """``--model router``: ``fit_router`` on the labelled mixed stream for
    ``epochs x steps_per_epoch`` steps, then the Flax-layout export
    ``checkpoints/noise_router.ckpt`` (and with ``--export_dir`` the same
    there), each with a sidecar recording the training window."""
    import torch

    from audiodenoiser_torch.models.convert import router_flax_from_state_dict
    from audiodenoiser_torch.models.router import NoiseClassifier
    from audiodenoiser_torch.train.checkpoints import export_model
    from audiodenoiser_torch.train.router import fit_router
    from audiodenoiser_torch.utils.profiling import maybe_trace

    mixer, _ = _mixers(args, device)
    steps = args.epochs * (args.steps_per_epoch or max(1, len(mixer) // args.batch_size))
    print(f"On-device pipeline: {len(mixer)} clean chunks, {steps} router steps.")
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    with maybe_trace(args.profile_dir):
        state, acc = fit_router(mixer, steps=steps, batch_size=args.batch_size,
                                learning_rate=args.learning_rate, seed=args.seed,
                                model=NoiseClassifier(dtype=dtype))
    print(f"Router held-out accuracy: {acc:.3f}")
    params = router_flax_from_state_dict(state.model.state_dict())

    def export_router(path):
        export_model(path, params, {})
        # the training crop, so that windowed scoring matches it (load_mixture)
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump({"window": list(mixer.target_size)}, f)

    best = os.path.join(args.output_path, args.run_name, "checkpoints", "noise_router.ckpt")
    export_router(best)
    if args.export_dir:
        dst = os.path.join(args.export_dir, "noise_router.ckpt")
        export_router(dst)
        print(f"Exported router to {dst}")
    return {"best_path": best, "router_accuracy": acc}


def _mask_family(args, device, cfg):
    """``fit``'s state factory and steps for ``--model complex_mask`` (with
    ``cfg``'s schedule and accumulation), and the sidecar that records the
    head, the width, the variant, a rate other than 8 kHz and the teacher,
    with the JAX CLI's per-type defaults: SI-SDR weight 0.5, clamp 30 dB, bound 8 where
    the stream holds noise_cancellation (undoing its 0.2x attenuation needs
    ~5x gain), else 2; a residual head starts as a zero-initialised
    pass-through. The teacher is the live-BN model of ``--distill_from``
    in the run's dtype, frozen; ``--distill_features`` needs it at the
    student's bottleneck size (an s2d student's is half a plain
    teacher's)."""
    import torch

    from audiodenoiser_torch.eval.runner import load_model_from_path
    from audiodenoiser_torch.models.unet import width_kwargs
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
    if args.width_mult != 1.0:
        meta["width_mult"] = args.width_mult
    meta.update(_variant_meta(args))
    if args.sample_rate != 8000:
        meta["sample_rate"] = args.sample_rate
    teacher = None
    if args.distill_from:
        teacher = load_model_from_path(args.distill_from, dtype=dtype, device=device,
                                       stem="mask_denoiser", fold=False).requires_grad_(False)
        if args.distill_features and teacher.s2d_stem != args.s2d_stem:
            raise SystemExit(
                "--distill_features compares the student's and the teacher's bottleneck "
                "maps, which need the same --s2d_stem: an s2d bottleneck is half the size "
                f"of a plain one (student s2d_stem={args.s2d_stem}, teacher "
                f"s2d_stem={teacher.s2d_stem})")
        meta["distilled_from"] = args.distill_from
        if args.distill_features:
            meta["distill_features"] = args.distill_features
    factory = lambda: mask_lib.create_mask_train_state(
        args.seed, mask_lib.ComplexMaskUNet(dtype=dtype, mask_bound=bound, residual=residual,
                                            zero_out_init=residual,
                                            attn_bottleneck=args.attn_bottleneck,
                                            s2d_stem=args.s2d_stem, s2d_skip=args.s2d_skip,
                                            **width_kwargs(args.width_mult)),
        learning_rate=args.learning_rate, device=device, schedule=cfg.lr_schedule,
        warmup_steps=cfg.warmup_steps, total_steps=cfg.total_steps,
        grad_accum=cfg.grad_accum)
    steps = mask_lib.make_mask_steps(si_w, si_clamp, teacher=teacher,
                                     distill_weight=args.distill_weight,
                                     distill_feat_weight=args.distill_features)
    return {"state_factory": factory, "steps": steps}, meta


def _check_pp(args) -> None:
    """JAX's refusals of ``--pp_stages``, word for word."""
    if args.model != "unet":
        raise SystemExit("--pp_stages supports the unet family only")
    if args.attn_bottleneck:
        raise SystemExit("--pp_stages does not support "
                         "--attn_bottleneck (the 1F1B stage splitter "
                         "carries convolutional blocks only)")
    if args.s2d_stem:
        raise SystemExit("--pp_stages does not support --s2d_stem "
                         "(the 1F1B stage splitter assumes the plain "
                         "full-resolution stem/head)")
    if args.lr_schedule != "constant" or args.ema_decay or args.fsdp:
        raise SystemExit(
            "--pp_stages supports the constant-LR AdamW path only "
            "(drop --lr_schedule/--ema_decay/--fsdp)"
        )


def _pp_devices(n_stages: int, device) -> list:
    """The stages' devices: ``device`` n times on the CPU; on the card the
    process's first ``n_stages`` cards (a launcher's local rank r takes
    cards r*n .. r*n + n - 1), which must divide the visible cards."""
    import torch

    if device.type != "cuda":
        return [device] * n_stages
    nd = torch.cuda.device_count()
    if nd % n_stages:
        raise SystemExit(f"--pp_stages {n_stages} does not divide {nd} devices")
    start = int(os.environ.get("LOCAL_RANK", 0)) * n_stages
    if start + n_stages > nd:
        raise SystemExit(f"--pp_stages {n_stages} on local rank {start // n_stages} needs "
                         f"cards {start}..{start + n_stages - 1}; {nd} are visible")
    return [torch.device("cuda", start + i) for i in range(n_stages)]


def _train_pp(args, cfg, train_batches, val_batches, device) -> dict:
    """1F1B pipeline-parallel training (``--pp_stages``), JAX's ``_train_pp``:
    each (B, C, F, T) batch in (n_micro, B / n_micro, ...) microbatches
    (a ragged batch wrap-padded to the static shape: dropped in training
    when full batches came before it, its real rows alone scored in
    validation), ``PipelineTrainer.step``, validation through the pipelined
    forward, the best model exported as ``checkpoints/best_model.ckpt`` and
    the resume state (full weights, AdamW's moments by name, the step,
    epoch and best loss) as ``checkpoints/pp_train_state.pt``. Every rank
    of the process group is a data replica; rank 0 writes."""
    import logging
    from itertools import chain

    import numpy as np
    import torch
    import torch.distributed as dist

    from audiodenoiser_torch.losses import combined_perceptual_loss
    from audiodenoiser_torch.models.convert import flax_from_state_dict
    from audiodenoiser_torch.models.unet import width_kwargs
    from audiodenoiser_torch.parallel import distributed
    from audiodenoiser_torch.parallel.pipeline_train import PipelineTrainer
    from audiodenoiser_torch.train import checkpoints as ckpt_lib
    from audiodenoiser_torch.train import loop as loop_mod
    from audiodenoiser_torch.train.logging_utils import ScalarWriter, setup_logger

    S, M = args.pp_stages, args.pp_microbatches
    devices = _pp_devices(S, device)
    dp = distributed.world_size()
    if cfg.batch_size % (M * dp):
        raise SystemExit(
            f"batch_size {cfg.batch_size} must divide by "
            f"pp_microbatches*data ({M}*{dp})"
        )
    mb = cfg.batch_size // (M * dp)
    primary = distributed.is_primary()
    run_dir = os.path.join(cfg.output_path, cfg.run_name)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    if primary:
        logger = setup_logger(os.path.join(run_dir, "training.log"))
    else:
        logger = logging.getLogger("unet_training_logger.follower")
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
    logger.info(f"--- 1F1B pipeline-parallel run: mesh {dict(data=dp, stage=S)}, "
                f"{M} microbatches x {mb} per replica ---")

    # one batch for the sample shape; the model comes from loop.UNet, so
    # the architecture is the monolithic path's
    it0 = iter(train_batches(0))
    first = next(it0)
    c_dim, f_dim, t_dim = tuple(first[0].shape[1:])
    dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    model = loop_mod.init_flax_like(
        loop_mod.UNet(dtype=dtype, remat=False, **width_kwargs(cfg.width_mult)), cfg.seed)
    trainer = PipelineTrainer(
        devices, micro_batch=mb, n_micro=M, input_shape=(c_dim, f_dim, t_dim),
        features=model.features, bottleneck=model.bottleneck_width,
        out_channels=model.out_channels, dtype=dtype, learning_rate=cfg.learning_rate,
        data_group=dist.group.WORLD if dp > 1 else None, in_channels=c_dim)
    state = trainer.init(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"U-NET Model initialized. Trainable parameters: {n_params:,}")
    del model

    start_epoch, best_val, exported_best = 0, float("inf"), False
    best_path = os.path.join(ckpt_dir, "best_model.ckpt")
    resume_path = os.path.join(ckpt_dir, "pp_train_state.pt")
    if cfg.resume and os.path.exists(resume_path):
        restored = ckpt_lib.restore_train_state(resume_path, "cpu")
        state = trainer.pack_state(restored["model"], restored["moments"], restored["step"])
        start_epoch = int(restored["epoch"]) + 1
        # --ckpt_every makes the resume state older than the best export,
        # whose sidecar keeps best_val honest (see fit)
        best_val = ckpt_lib.best_val_floor(best_path, float(restored["best_val"]))
        logger.info(f"Resumed from epoch {start_epoch} (best val {best_val:.6f})")

    eff = M * mb * dp

    def prep(x):
        """A batch in (M, mb * dp, ...) microbatches, wrap-padded to the
        static shape, and its count of real rows."""
        x = torch.as_tensor(x, dtype=torch.float32)
        n = x.shape[0]
        if n != eff:
            x = x[torch.arange(eff, device=x.device) % n]
        return x.reshape(M, mb * dp, *x.shape[1:]), n

    writer = (ScalarWriter(os.path.join(run_dir, "tensorboard_logs")) if primary
              else loop_mod._NoWriter())
    history, global_step = [], 0
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        batches_iter = chain([first], it0) if epoch == 0 else train_batches(epoch)
        train_losses = []
        for noisy, clean in batches_iter:
            pn, n = prep(noisy)
            pc, _ = prep(clean)
            if n != eff and train_losses:
                # wrap-padding would weigh repeated rows up to eff/n times:
                # drop the ragged tail, as full batches came this epoch
                logger.info(f"  dropping ragged final batch ({n} < {eff} rows)")
                continue
            state, loss = trainer.step(state, pn, pc)
            train_losses.append(float(loss))
            global_step += 1
        train_loss = float(np.mean(train_losses)) if train_losses else float("nan")
        writer.add_scalar("Loss/train", train_loss, epoch)
        val_losses = []  # (the loss over a batch's real rows, their count)
        with torch.no_grad():
            for noisy, clean in val_batches():
                pn, n = prep(noisy)
                pc, _ = prep(clean)
                out = trainer.forward(state, pn)
                flat = out.reshape(-1, *out.shape[2:])[:n]
                flat_c = pc.reshape(-1, *pc.shape[2:])[:n].to(flat.device)
                val_losses.append((float(combined_perceptual_loss(flat, flat_c).total), n))
        val_loss = (float(np.average([v for v, _ in val_losses],
                                     weights=[n for _, n in val_losses]))
                    if val_losses else train_loss)
        writer.add_scalar("Loss/validation", val_loss, epoch)
        dt = time.perf_counter() - t0
        logger.info(f"Epoch {epoch + 1}/{cfg.epochs} -> Train Loss: {train_loss:.6f}"
                    f" | Validation Loss: {val_loss:.6f} | {dt:.1f}s")
        if not np.isfinite(train_loss):
            logger.error("Non-finite training loss; aborting run.")
            raise FloatingPointError(f"diverged at epoch {epoch}")
        history.append({"epoch": epoch, "train": train_loss, "val": val_loss})
        if val_loss < best_val:
            best_val = val_loss
            if primary:
                tree = flax_from_state_dict(trainer.unpack_state(state))
                ckpt_lib.export_model(best_path, tree["params"], tree["batch_stats"])
                ckpt_lib.record_best_val(best_path, best_val, epoch)
            exported_best = True
            logger.info(f"New best model saved to {best_path} (Val Loss: {best_val:.6f})")
        if (epoch + 1) % max(1, cfg.ckpt_every) == 0 or epoch == cfg.epochs - 1:
            if primary:
                ckpt_lib.save_train_state(resume_path, {
                    "model": trainer.unpack_state(state),
                    "moments": trainer.optimizer_state(state), "step": state.step,
                    "epoch": epoch, "best_val": best_val})
    writer.close()
    if dp > 1:  # every rank leaves once rank 0's files are written
        dist.barrier()
    logger.info("--- Training Finished ---")
    return {"best_val": best_val, "best_path": best_path, "run_dir": run_dir,
            "history": history, "state": state, "exported_best": exported_best,
            "steps": global_step, "trainer": trainer}


if __name__ == "__main__":
    main()
