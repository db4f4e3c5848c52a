"""CLI: per-noise-type evaluation on the GPU (port of ``cli/test.py``).

  python -m audiodenoiser_torch.cli.test --test_data_dir ./data/test_processed \\
      --saved_models_dir ./saved_models --output_dir ./data/test_output_ensemble
  python -m audiodenoiser_torch.cli.test --model complex_mask --universal \\
      --clean_dir ./data/test/clean --noise_dir ./data/test/noise --n_seeds 3

``--model unet`` loads each noise type's specialist (or, with
``--universal``, ``unet_denoiser_mixed``) and evaluates it on
``cli.create_test_dataset``'s ``.npy`` set, reconstructing example wavs by
Griffin-Lim in ``--gl_mode``; ``--model complex_mask`` evaluates the
mask family in the waveform domain over the test wavs, ``--n_seeds``
corruption draws each (``{nt}_metrics_multiseed.txt``). Both write the
reference's artifact names. ``--auto_route`` evaluates the four
specialists behind the noise router (``eval.ensemble``): the magnitude
family over the ``.npy`` set, the mask family over the wavs, each noise
type's routing accuracy in ``{nt}_routed_metrics.txt``. The flags are the
JAX CLI's, plus ``--device`` (default: the GPU). ``--mesh`` and
``--model_parallel`` run the evaluation on a ('data', 'model') device
mesh (``parallel.make_mesh``; under ``torchrun`` one rank per card, rank 0
writing): each batch's rows over ``data``, the wide convs over ``model``.
With four or more ranks, ``--auto_route`` of the magnitude family takes
the expert-parallel dispatch (``eval.ensemble``): ``--ep auto`` the
all-to-all one over the first four ranks, ``--ep dense`` (a multiple of
four ranks) the dense one; ``--ep off``, or fewer ranks, the
host-bucketed dispatch. On the GPU, each noise type's K1/K2 launches are
printed as one ``[launches]`` JSON line.

  torchrun --nproc_per_node 2 -m audiodenoiser_torch.cli.test --mesh on ...
  torchrun --nproc_per_node 4 -m audiodenoiser_torch.cli.test --auto_route --ep auto ...
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Specialized per-noise-type evaluation (CUDA)")
    p.add_argument("--test_data_dir", default="./data/test_processed")
    p.add_argument("--saved_models_dir", default="./saved_models")
    p.add_argument("--output_dir", default="./data/test_output_ensemble")
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--n_fft", type=int, default=512)
    p.add_argument("--hop_length", type=int, default=128)
    p.add_argument(
        "--noise_types",
        nargs="+",
        default=["white", "urban", "reverb", "noise_cancellation"],
    )
    p.add_argument("--num_audio_examples", type=int, default=5)
    p.add_argument(
        "--gl_mode",
        choices=["reference_gl", "griffin_lim"],
        default="reference_gl",
        help="reference_gl replicates the reference's loop; griffin_lim is the "
        "correct magnitude-reimposing algorithm.",
    )
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--model", choices=["unet", "complex_mask"], default="unet",
        help="unet: magnitude ensemble over test_processed npy artifacts; "
        "complex_mask: waveform-domain eval of the mask_denoiser ensemble "
        "over --clean_dir/--noise_dir wavs.",
    )
    p.add_argument("--clean_dir", default="./data/test/clean")
    p.add_argument("--noise_dir", default="./data/test/noise")
    p.add_argument(
        "--universal", action="store_true",
        help="evaluate the single universal model ({stem}_mixed.ckpt) on every "
        "--noise_types entry, instead of one specialized model per type.",
    )
    p.add_argument("--mesh", choices=["auto", "on", "off"], default="auto",
                   help="auto: shard eval batches over a ('data','model') device mesh "
                   "iff the process group has more than one rank; on: force (one rank "
                   "without a launcher); off: no mesh. Same semantics as cli.train.")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="channel-TP degree on the device mesh; the data axis takes the "
                   "remaining ranks (world size / model_parallel).")
    p.add_argument(
        "--n_seeds", type=int, default=1,
        help="waveform-domain evals only: repeat the eval with seeds "
        "seed..seed+n-1 (fresh corruption draws) and report mean +- std "
        "of every metric ({nt}_metrics_multiseed.txt).",
    )
    p.add_argument(
        "--bypass_db", type=float, default=40.0,
        help="identity-bypass gate for waveform-domain evals: clips whose "
        "relative model-change energy is below -bypass_db are emitted "
        "bit-exactly as the input. <=0 disables.",
    )
    p.add_argument(
        "--auto_route", action="store_true",
        help="evaluate the four specialists behind the trained noise router "
        "(noise_router.ckpt, cli.train --model router): each clip is routed "
        "to its predicted specialist and the routing accuracy is reported.",
    )
    p.add_argument(
        "--ep", choices=["auto", "dense", "off"], default="auto",
        help="--auto_route expert dispatch when the process group has four or more "
        "ranks: auto = capacity-based all_to_all routed compute (each clip forwarded "
        "once, overflow passes on the device); dense = every expert computes, "
        "masked sum; off = host-bucketed.",
    )
    p.add_argument("--device", default=None, help="default: the GPU")
    args = p.parse_args(argv)
    if args.auto_route and (args.mesh == "on" or args.model_parallel > 1):
        raise SystemExit("--auto_route builds its own expert-parallel mesh and does not "
                         "honor --mesh on/--model_parallel; drop those flags")
    return args


def _build_mesh(args, device):
    """The ('data', 'model') mesh of ``--mesh``/``--model_parallel``, or None."""
    from audiodenoiser_torch.parallel import distributed

    use = {"auto": None, "on": True, "off": False}[args.mesh]
    if use is None:
        use = distributed.world_size() > 1 or args.model_parallel > 1
    if not use:
        return None
    from audiodenoiser_torch.parallel.mesh import make_mesh

    mesh = make_mesh(model_parallel=max(1, args.model_parallel), device=device)
    print(f"Device mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    return mesh


def _write_multiseed(path: str, noise_type: str, per_seed: list) -> dict:
    """Mean and std of every metric over the seeds, written (by rank 0) as
    the JAX CLI writes them; returns ``{key: mean, key_std: std}``."""
    import numpy as np

    from audiodenoiser_torch.parallel.distributed import is_primary

    keys = sorted(set.intersection(*(set(m) for m in per_seed)))
    agg = {k: (float(np.mean([m[k] for m in per_seed])), float(np.std([m[k] for m in per_seed])))
           for k in keys}
    with open(path if is_primary() else os.devnull, "w") as f:
        f.write(f"Multi-seed ({len(per_seed)} corruption draws) waveform metrics for "
                f"'{noise_type}' (mean +- std):\n")
        for k in keys:
            mu, sd = agg[k]
            # pesq_* is the calibrated approximation, not conformant P.862
            f.write(f"{k.replace('pesq', 'pesq_approx')}: {mu:.3f} +- {sd:.3f}\n")
    print(f"multi-seed ({len(per_seed)}x): SI-SDR {agg['si_sdr_noisy'][0]:.2f} -> "
          f"{agg['si_sdr'][0]:.2f} +- {agg['si_sdr'][1]:.2f} dB")
    return {k: mu for k, (mu, _) in agg.items()} | {f"{k}_std": sd for k, (_, sd) in agg.items()}


def _report_launches(noise_type: str, device) -> None:
    """On the GPU, print the K1/K2 launches of one noise type's eval, by
    entry, and zero the counters for the next."""
    from audiodenoiser_torch.ops.cuda import (
        istft_kernel,
        reset_launch_counts,
        stft_kernel,
        variant_launches,
    )

    if device.type == "cuda":
        counts = {k.__name__: variant_launches(k) for k in (stft_kernel, istft_kernel)}
        print(f"[launches] {noise_type} {json.dumps(counts)}", flush=True)
    reset_launch_counts()


def _ep_mesh(args, device):
    """JAX's choice of expert dispatch, by the process group's world size
    (the counterpart of ``jax.device_count()``): with four or more ranks
    ``--ep auto`` the all-to-all mesh, ``--ep dense`` the dense mesh when
    four divide the ranks; else None, the host-bucketed dispatch."""
    from audiodenoiser_torch.eval.ensemble import make_a2a_mesh, make_ep_mesh
    from audiodenoiser_torch.parallel.distributed import world_size

    n = world_size()
    if args.model != "unet" or args.ep == "off" or n < 4:
        return None
    if args.ep == "dense":
        if n % 4:
            return None
        mesh = make_ep_mesh(device=device)
    else:  # auto: routed all-to-all compute is the default
        mesh = make_a2a_mesh(device=device)
    print(f"Expert-parallel mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"({'dense' if args.ep == 'dense' else 'a2a'})")
    return mesh


def _auto_route(args, device, dtype):
    """``--auto_route``: the routed mixture over the ``.npy`` set (magnitude
    family, with the dispatch of ``_ep_mesh``) or the wavs (mask family,
    host-bucketed)."""
    from audiodenoiser_torch.eval.ensemble import (
        evaluate_routed,
        evaluate_routed_waveform,
        load_mixture,
    )
    from audiodenoiser_torch.ops.cuda import reset_launch_counts

    stem = "mask_denoiser" if args.model == "complex_mask" else "unet_denoiser"
    mixture = load_mixture(args.saved_models_dir, dtype=dtype, stem=stem, n_fft=args.n_fft,
                           hop_length=args.hop_length, device=device)
    reset_launch_counts()
    if args.model == "complex_mask":
        # mask experts take complex STFTs: the waveform domain, over the wavs
        results = evaluate_routed_waveform(
            mixture, args.clean_dir, args.noise_dir, args.output_dir,
            noise_types=args.noise_types, sample_rate=args.sample_rate, seed=args.seed,
            bypass_db=args.bypass_db)
    else:
        results = evaluate_routed(mixture, args.test_data_dir, args.output_dir,
                                  noise_types=args.noise_types,
                                  ep_mesh=_ep_mesh(args, device))
    _report_launches("auto_route", device)
    return results


def main(argv=None):
    args = parse_args(argv)
    import torch

    from audiodenoiser_torch.device import resolve_device
    from audiodenoiser_torch.eval.runner import (
        DenoiserRunner,
        load_model_for_noise,
        test_noise_type_waveform,
        test_single_noise_type,
    )
    from audiodenoiser_torch.ops.cuda import reset_launch_counts
    from audiodenoiser_torch.parallel.distributed import (
        is_primary,
        local_device,
        maybe_initialize,
    )

    maybe_initialize(args.device)  # a no-op without a launcher
    device = resolve_device(local_device(args.device))
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if args.auto_route:
        return _auto_route(args, device, dtype)
    mesh = _build_mesh(args, device)
    if mesh is None and not is_primary():  # --mesh off under a launcher: rank 0 alone
        return {}
    print("Starting specialized test for each noise type...")
    os.makedirs(args.output_dir, exist_ok=True)
    results = {}
    stem = "mask_denoiser" if args.model == "complex_mask" else "unet_denoiser"
    loaded = None
    if args.universal:  # one mixed-corruption model for every noise type
        try:
            loaded = load_model_for_noise("mixed", args.saved_models_dir, dtype=dtype,
                                          device=device, stem=stem)
        except FileNotFoundError:
            print(f"Universal model '{stem}_mixed' not found. Nothing to do.")
            return results
    # one runner per distinct model
    runner = None if loaded is None else DenoiserRunner(
        loaded, args.n_fft, args.hop_length, device=device, mesh=mesh)
    reset_launch_counts()
    for noise_type in args.noise_types:
        try:
            model = loaded or load_model_for_noise(noise_type, args.saved_models_dir,
                                                   dtype=dtype, device=device, stem=stem)
        except FileNotFoundError:
            print(f"Model for noise type '{noise_type}' not found. Skipping.")
            continue
        if args.model == "unet":
            results[noise_type] = test_single_noise_type(
                model, noise_type, test_data_dir=args.test_data_dir,
                output_dir=args.output_dir, sample_rate=args.sample_rate, n_fft=args.n_fft,
                hop_length=args.hop_length, num_audio_examples=args.num_audio_examples,
                gl_mode=args.gl_mode, seed=args.seed, device=device, mesh=mesh)
            _report_launches(noise_type, device)
            continue
        if loaded is None:
            runner = DenoiserRunner(model, args.n_fft, args.hop_length, device=device,
                                    mesh=mesh)
        per_seed = []
        for k in range(max(1, args.n_seeds)):
            m = test_noise_type_waveform(
                model, noise_type, clean_dir=args.clean_dir, noise_dir=args.noise_dir,
                output_dir=args.output_dir, sample_rate=args.sample_rate, n_fft=args.n_fft,
                hop_length=args.hop_length, num_audio_examples=args.num_audio_examples,
                seed=args.seed + k, bypass_db=args.bypass_db, write_artifacts=(k == 0),
                runner=runner)
            if m is not None:
                per_seed.append(m)
        _report_launches(noise_type, device)
        if not per_seed:
            continue
        results[noise_type] = per_seed[0]
        if len(per_seed) > 1:
            results[noise_type] = _write_multiseed(
                os.path.join(args.output_dir, f"{noise_type}_metrics_multiseed.txt"),
                noise_type, per_seed)
    return results


if __name__ == "__main__":
    main()
