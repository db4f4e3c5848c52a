"""CLI: serve a denoiser over HTTP on the GPU.

Usage (the recommended deployment, the universal complex-mask model):
  python -m audiodenoiser_torch.cli.serve --model complex_mask \\
      --noise_type mixed --saved_models_dir ./saved_models --port 8800

  curl -s -X POST --data-binary @noisy.wav \\
      'http://127.0.0.1:8800/denoise' > denoised.wav

Loads ``{stem}_{noise_type}.ckpt`` (stem ``mask_denoiser`` for
``--model complex_mask``, ``unet_denoiser`` for ``--model unet``, which
also takes the reference ``unet_denoiser_{noise_type}.pth``), folds its
BatchNorm into the convolutions (``--no-fold``: the live-BN eval model)
and serves ``POST /denoise`` in ``--mode`` (``?mode=`` per request; the
magnitude model serves ``noisy_phase``, ``griffin_lim`` and
``reference_gl``), plus streaming sessions in the model's own mode:

  curl -s -X POST 'http://127.0.0.1:8800/stream/start'   # {"session": ID, ...}
  curl -s -X POST --data-binary @samples.f32 'http://127.0.0.1:8800/stream/ID'
  curl -s -X POST 'http://127.0.0.1:8800/stream/ID/flush'

with raw little-endian float32 samples at ``--sample_rate`` in and out
(``?rate=`` at start: the client's own rate, resampled in the stream).
Sessions are WOLA with one chunk (``bucket_seconds``) of latency;
``--stream_latency_ms`` makes them low-latency sessions of that budget,
``--stream_pool N|auto`` serves them from one pool whose live streams
advance in one batch per hop. ``POST /admin/reload`` reloads the
checkpoint from ``--saved_models_dir`` without dropping traffic: open
sessions finish on their generation.

``--auto_route`` also loads the four specialists ``{stem}_{nt}.ckpt`` and
the noise router ``noise_router.ckpt`` (``cli.train --model router``) and
serves ``mode=auto``, the default then: each coalesced batch is classified
on the card and each predicted group runs through its specialist (folded
unless ``--no-fold``, on the same precision path). Streams opened with no
mode or ``?mode=auto`` are routed sessions (``RoutedStreamingSession``)
that re-route mid-stream.

``--mesh`` and ``--model_parallel`` serve on a ('data', 'model') device
mesh (``parallel.make_mesh``): each batch's rows over ``data``, the wide
convs over ``model``. Under ``torchrun`` (one rank per card) rank 0 runs
the HTTP service and every other rank follows its meshed calls
(``parallel.follow``): whole-clip requests, stream sessions, the
``--auto_route`` experts and ``/admin/reload``.

  torchrun --nproc_per_node 2 -m audiodenoiser_torch.cli.serve --mesh on ...
"""

from __future__ import annotations

import argparse
import datetime
import threading

# the modes each model serves, its own first
MODEL_MODES = {"unet": ("noisy_phase", "griffin_lim", "reference_gl"),
               "complex_mask": ("complex_mask",)}
# --precision_path -> the runner's precision: JAX's Pallas path is the kernels
PRECISION_PATHS = {"auto": "kernel", "pallas": "kernel", "matmul": "matmul", "fft": "fft"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HTTP denoising service (CUDA)")
    p.add_argument("--noise_type", default="white",
                   choices=["white", "urban", "reverb", "noise_cancellation",
                            "mixed"],
                   help="which specialised checkpoint to serve; 'mixed' is the "
                   "universal model, the recommended deployment of the mask family")
    p.add_argument("--saved_models_dir", default="./saved_models")
    p.add_argument("--model", choices=["unet", "complex_mask"], default="unet")
    p.add_argument("--mode", default=None,
                   choices=["noisy_phase", "complex_mask", "griffin_lim", "reference_gl",
                            "auto"],
                   help="default reconstruction mode of /denoise: noisy_phase (the "
                   "default), griffin_lim or reference_gl for --model unet, "
                   "complex_mask for --model complex_mask, auto (the default with "
                   "--auto_route); streams keep the model's own mode")
    p.add_argument("--auto_route", action="store_true",
                   help="load the four specialists and the trained noise router "
                   "(noise_router.ckpt) and serve mode=auto: each batch is classified "
                   "on the card and each group runs through its predicted specialist")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--bucket_seconds", type=float, default=2.0,
                   help="requests are padded to multiples of this many "
                   "seconds so the device sees few shapes; also the chunk "
                   "of the WOLA sessions and the low-latency sessions' window")
    p.add_argument("--max_seconds", type=float, default=60.0)
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16",
                   help="compute dtype of the U-Net")
    p.add_argument("--precision_path", choices=list(PRECISION_PATHS), default="auto",
                   help="STFT/iSTFT path: auto and pallas take the CUDA kernels "
                   "(K1/K2), fft the torch.fft versions, matmul the real-DFT-basis "
                   "STFT with the FFT iSTFT")
    p.add_argument("--fold", action=argparse.BooleanOptionalAction, default=True,
                   help="fold eval-mode BatchNorm into the convolutions (the "
                   "default); --no-fold serves the live-BN eval model")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the first-bucket warm-up at start and on reload")
    p.add_argument("--stream_latency_ms", type=float, default=None,
                   help="serve /stream with low-latency sessions of this "
                   "end-to-end budget (e.g. 224) over a rolling window of one "
                   "bucket, instead of WOLA sessions of one bucket's latency")
    p.add_argument("--stream_pool", default=None, metavar="N|auto",
                   help="serve /stream from one pool of this capacity whose "
                   "live streams advance in one batch per hop; every step "
                   "computes the whole capacity, so size it to the expected "
                   "concurrency; 'auto' sizes it to the card's memory "
                   "(eval.streaming.auto_pool_capacity). WOLA sessions only")
    p.add_argument(
        "--bypass_db", type=float, default=None,
        help="identity-bypass gate: clips whose relative model-change "
        "energy is below -bypass_db are returned verbatim. Off unless set; "
        "<=0 disables.",
    )
    p.add_argument("--mesh", choices=["auto", "on", "off"], default="auto",
                   help="auto: serve over a ('data','model') device mesh iff the process "
                   "group has more than one rank; on: force (one rank without a "
                   "launcher); off: no mesh")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="channel-TP degree on the device mesh; the data axis takes the "
                   "remaining ranks")
    p.add_argument("--device", default=None, help="default: the GPU")
    args = p.parse_args(argv)
    if args.stream_pool is not None:
        if args.stream_pool != "auto":
            try:
                args.stream_pool = int(args.stream_pool)
            except ValueError:
                raise SystemExit("--stream_pool must be an integer or 'auto'") from None
            if args.stream_pool < 1:
                raise SystemExit("--stream_pool must be >= 1")
        if args.stream_latency_ms is not None:
            raise SystemExit("--stream_pool supports WOLA sessions only (drop "
                             "--stream_latency_ms)")
    served = MODEL_MODES[args.model] + (("auto",) if args.auto_route else ())
    if args.mode == "auto" and not args.auto_route:
        raise SystemExit("--mode auto requires --auto_route (the router and the specialists)")
    if args.mode not in (None, *served):
        raise SystemExit(f"--mode {args.mode} needs another model: --model {args.model} "
                         f"serves {', '.join(served)}")
    args.mode = args.mode or ("auto" if args.auto_route else served[0])
    return args


def build_mesh(args):
    """The ('data', 'model') mesh of ``--mesh``/``--model_parallel``, or None."""
    from audiodenoiser_torch.parallel import distributed

    use = {"auto": None, "on": True, "off": False}[args.mesh]
    if use is None:
        use = distributed.world_size() > 1 or args.model_parallel > 1
    if not use:
        return None
    from audiodenoiser_torch.parallel.mesh import make_mesh

    mesh = make_mesh(model_parallel=max(1, args.model_parallel), device=args.device)
    print(f"Device mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    return mesh


def build_generation(args, mesh=None) -> dict:
    """Load the checkpoints and build everything one serving generation
    needs: the runner, with ``--auto_route`` the mixture (router and
    specialists) and one runner per expert, and the stream engine (a WOLA
    or low-latency streamer, or a pool), each runner on ``mesh`` when
    given. At start and on each ``/admin/reload``, on every rank."""
    import torch

    from audiodenoiser_torch.eval import streaming
    from audiodenoiser_torch.eval.runner import DenoiserRunner, load_model_for_noise

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    stem = "mask_denoiser" if args.model == "complex_mask" else "unet_denoiser"
    path = PRECISION_PATHS[args.precision_path]
    model = load_model_for_noise(args.noise_type, args.saved_models_dir, dtype=dtype,
                                 device=args.device, stem=stem, fold=args.fold)
    runner = DenoiserRunner(model, device=args.device, precision=path, mesh=mesh)
    chunk = int(args.bucket_seconds * args.sample_rate)
    chunk -= chunk % 2  # WOLA needs an even chunk
    gen = {"runner": runner, "streamer": None, "pooled": None, "mixture": None,
           "router": None, "expert_runners": None}
    if args.auto_route:
        from audiodenoiser_torch.eval.ensemble import load_mixture

        mixture = load_mixture(args.saved_models_dir, dtype=dtype, stem=stem, fold=args.fold,
                               device=args.device, precision=path, mesh=mesh)
        gen.update(mixture=mixture, router=(mixture.router, mixture.router_window),
                   expert_runners=dict(enumerate(mixture.runners)))
        print(f"Auto-routing over the {stem} specialists")
    if args.stream_latency_ms is not None:
        gen["streamer"] = streaming.LowLatencyStreamingDenoiser.from_latency_budget(
            runner, args.stream_latency_ms, sample_rate=args.sample_rate,
            window_samples=chunk)
    else:
        gen["streamer"] = streaming.StreamingDenoiser(runner, chunk_samples=chunk,
                                                      sample_rate=args.sample_rate)
    if args.stream_pool is not None:
        capacity = args.stream_pool
        if capacity == "auto":
            capacity = streaming.auto_pool_capacity(runner, chunk_samples=chunk)
            print(f"--stream_pool auto: sized the pool to {capacity} streams")
        gen["pooled"] = streaming.PooledStreamSessions(streaming.MultiStreamWola(
            runner, capacity=capacity, chunk_samples=chunk, sample_rate=args.sample_rate))
    return gen


def build_server(args, mesh=None):
    """The service and its (not started) HTTP server, with streaming and
    ``/admin/reload``, its runners on ``mesh`` when given (rank 0 of a
    meshed service: its other ranks run ``follow``)."""
    from audiodenoiser_torch.parallel import follow
    from audiodenoiser_torch.serve import DenoiseService, make_http_server

    stem = "mask_denoiser" if args.model == "complex_mask" else "unet_denoiser"
    calls = follow.active()
    gen = {"cur": build_generation(args, mesh)}
    if calls is not None:
        calls.start()
    gen["cur"]["gen"] = 0
    if not args.no_warmup:
        print("Warming up (building kernels, first-bucket batches)...")
    chunk = int(args.bucket_seconds * args.sample_rate) // 2 * 2
    service = DenoiseService(
        gen["cur"]["runner"],
        sample_rate=args.sample_rate,
        bucket_samples=int(args.bucket_seconds * args.sample_rate),
        max_seconds=args.max_seconds,
        default_mode=args.mode,
        warmup=not args.no_warmup,
        router=gen["cur"]["router"],
        expert_runners=gen["cur"]["expert_runners"],
        auto_expert_mode="complex_mask" if args.model == "complex_mask" else "noisy_phase",
        bypass_db=args.bypass_db,
    )

    def stream_factory(mode):
        cur = gen["cur"]  # one snapshot: the session and its generation
        streamer = cur["streamer"]
        if cur["mixture"] is not None and mode in (None, "auto"):
            from audiodenoiser_torch.eval.streaming import RoutedStreamingSession

            return RoutedStreamingSession(
                cur["mixture"], chunk_samples=chunk, sample_rate=args.sample_rate,
                precision=PRECISION_PATHS[args.precision_path]), cur["gen"]
        if mode not in (None, streamer.mode):
            raise NotImplementedError(f"this server streams mode {streamer.mode!r} only")
        if cur["pooled"] is not None:
            return cur["pooled"].session(), cur["gen"]  # IndexError when full: 503
        return streamer.session(), cur["gen"]

    reload_lock = threading.Lock()

    def reload_fn():
        # the new generation is built and warmed up before the swap, so a
        # broken checkpoint directory never stops the serving one
        with reload_lock:
            build = lambda: build_generation(args, mesh)  # noqa: E731
            new = build() if calls is None else calls.reload(build)
            new["gen"] = service.reload(runner=new["runner"], router=new["router"],
                                        expert_runners=new["expert_runners"],
                                        warmup=not args.no_warmup)
            gen["cur"] = new
            print(f"Reloaded {args.saved_models_dir} (generation {new['gen']})")
            return {"generation": new["gen"], "saved_models_dir": args.saved_models_dir}

    server = make_http_server(service, args.host, args.port, stream_factory=stream_factory,
                              reload_fn=reload_fn)
    server.current_generation = lambda: gen["cur"]  # what serves now, for inspection
    return service, server, f"{stem}_{args.noise_type}"


def serve_follower(args, mesh) -> None:
    """A rank past 0 of a meshed service: build what rank 0 builds and make
    its meshed calls until it stops."""
    from audiodenoiser_torch.parallel import follow as follow_lib

    build_generation(args, mesh)
    follow_lib.active().follow(lambda: build_generation(args, mesh))


def main(argv=None):
    args = parse_args(argv)
    from audiodenoiser_torch.parallel import distributed
    from audiodenoiser_torch.parallel import follow as follow_lib

    # a follower waits for the next request as long as it takes
    distributed.maybe_initialize(args.device, timeout=datetime.timedelta(days=30))
    mesh = build_mesh(args)
    calls = None
    if distributed.world_size() > 1:
        if mesh is None:  # --mesh off: rank 0 serves alone
            if not distributed.is_primary():
                return
        else:
            calls = follow_lib.install()
            if not distributed.is_primary():
                serve_follower(args, mesh)
                return
    service, server, name = build_server(args, mesh)
    host, port = server.server_address[:2]
    chunk = int(args.bucket_seconds * args.sample_rate) // 2 * 2
    stream = (f"low-latency {args.stream_latency_ms:g} ms" if args.stream_latency_ms is not None
              else f"WOLA chunk {chunk}")
    if args.stream_pool is not None:
        stream += f", pooled ({args.stream_pool})"
    print(f"Serving {name} on http://{host}:{port} "
          f"(mode={service.default_mode}, streaming {stream}, {service.runner.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        if calls is not None:
            calls.stop()


if __name__ == "__main__":
    main()
