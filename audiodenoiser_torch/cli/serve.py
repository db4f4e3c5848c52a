"""CLI: serve a BN-folded denoiser over HTTP on the GPU.

Usage (the recommended deployment, the universal complex-mask model):
  python -m audiodenoiser_torch.cli.serve --model complex_mask \\
      --noise_type mixed --saved_models_dir ./saved_models --port 8800

  curl -s -X POST --data-binary @noisy.wav \\
      'http://127.0.0.1:8800/denoise' > denoised.wav

Loads ``{stem}_{noise_type}.ckpt`` (stem ``mask_denoiser`` for
``--model complex_mask``, ``unet_denoiser`` for ``--model unet``, which
also takes the reference ``unet_denoiser_{noise_type}.pth``), folds its
BatchNorm into the convolutions and serves ``POST /denoise`` in
``--mode`` (``?mode=`` per request; the magnitude model serves
``noisy_phase``, ``griffin_lim`` and ``reference_gl``), plus WOLA
streaming sessions in the model's own mode with one chunk
(``bucket_seconds``) of latency:

  curl -s -X POST 'http://127.0.0.1:8800/stream/start'   # {"session": ID, ...}
  curl -s -X POST --data-binary @samples.f32 'http://127.0.0.1:8800/stream/ID'
  curl -s -X POST 'http://127.0.0.1:8800/stream/ID/flush'

with raw little-endian float32 samples at 8 kHz in and out.
"""

from __future__ import annotations

import argparse

SAMPLE_RATE = 8000
# options of the JAX CLI whose machinery is not ported yet
UNPORTED_FLAGS = {
    "stream_latency_ms": "ROADMAP A.9 (low-latency streaming sessions)",
    "stream_pool": "ROADMAP A.9 (pooled multi-stream sessions)",
    "auto_route": "ROADMAP A.10 (noise router and specialists)",
}
# default modes of the JAX CLI that no ported model serves yet
UNPORTED_MODES = {"auto": "ROADMAP A.10 (noise router and specialists)"}
# the modes each model serves, its own first
MODEL_MODES = {"unet": ("noisy_phase", "griffin_lim", "reference_gl"),
               "complex_mask": ("complex_mask",)}


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
                            *UNPORTED_MODES],
                   help="default reconstruction mode of /denoise: noisy_phase (the "
                   "default), griffin_lim or reference_gl for --model unet, "
                   "complex_mask for --model complex_mask; streams keep the "
                   "model's own mode")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--bucket_seconds", type=float, default=2.0,
                   help="requests are padded to multiples of this many "
                   "seconds so the device sees few shapes; also the chunk "
                   "of the /stream sessions")
    p.add_argument("--max_seconds", type=float, default=60.0)
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16",
                   help="compute dtype of the folded U-Net")
    p.add_argument(
        "--bypass_db", type=float, default=None,
        help="identity-bypass gate: clips whose relative model-change "
        "energy is below -bypass_db are returned verbatim. Off unless set; "
        "<=0 disables.",
    )
    p.add_argument("--device", default=None, help="default: the GPU")
    for name, item in UNPORTED_FLAGS.items():
        kind = {"action": "store_true"} if name == "auto_route" else {}
        p.add_argument(f"--{name}", default=argparse.SUPPRESS,
                       help=f"not ported yet: {item}", **kind)
    args = p.parse_args(argv)
    for name, item in UNPORTED_FLAGS.items():
        if hasattr(args, name):
            raise SystemExit(f"--{name} is not ported yet: {item}")
    served = MODEL_MODES[args.model]
    if args.mode in UNPORTED_MODES:
        raise SystemExit(f"--mode {args.mode} is not ported yet: {UNPORTED_MODES[args.mode]}")
    if args.mode not in (None, *served):
        raise SystemExit(f"--mode {args.mode} needs another model: --model {args.model} "
                         f"serves {', '.join(served)}")
    args.mode = args.mode or served[0]
    return args


def build_server(args):
    """The service and its (not started) HTTP server, with streaming."""
    import torch

    from audiodenoiser_torch.eval.runner import DenoiserRunner, load_model_for_noise
    from audiodenoiser_torch.eval.streaming import StreamingDenoiser
    from audiodenoiser_torch.serve import DenoiseService, make_http_server

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    stem = "mask_denoiser" if args.model == "complex_mask" else "unet_denoiser"
    model = load_model_for_noise(args.noise_type, args.saved_models_dir, dtype=dtype,
                                 device=args.device, stem=stem)
    runner = DenoiserRunner(model, device=args.device)
    print("Warming up (building kernels, first-bucket batches)...")
    bucket = int(args.bucket_seconds * SAMPLE_RATE)
    service = DenoiseService(
        runner,
        sample_rate=SAMPLE_RATE,
        bucket_samples=bucket,
        max_seconds=args.max_seconds,
        default_mode=args.mode,
        warmup=True,
        bypass_db=args.bypass_db,
    )
    # one shared streamer: WOLA sessions with a chunk of one bucket, made even
    streamer = StreamingDenoiser(runner, chunk_samples=bucket - bucket % 2,
                                 sample_rate=SAMPLE_RATE)

    def stream_factory(mode):
        if mode == "auto":
            raise NotImplementedError(
                f"routed streams are not ported yet: {UNPORTED_FLAGS['auto_route']}")
        if mode not in (None, streamer.mode):
            raise NotImplementedError(f"this server streams mode {streamer.mode!r} only")
        return streamer.session()

    server = make_http_server(service, args.host, args.port, stream_factory=stream_factory)
    return service, server, f"{stem}_{args.noise_type}"


def main(argv=None):
    args = parse_args(argv)
    service, server, name = build_server(args)
    host, port = server.server_address[:2]
    print(f"Serving {name} on http://{host}:{port} "
          f"(mode={service.default_mode}, streaming WOLA chunk "
          f"{int(args.bucket_seconds * SAMPLE_RATE) // 2 * 2}, "
          f"{service.runner.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
