"""CLI: serve a BN-folded denoiser over HTTP on the GPU.

Usage:
  python -m audiodenoiser_torch.cli.serve --noise_type white \
      --saved_models_dir ./saved_models --port 8800

  curl -s -X POST --data-binary @noisy.wav \
      'http://127.0.0.1:8800/denoise' > denoised.wav

Loads the reference ``unet_denoiser_{noise_type}.pth`` state_dict, folds
its BatchNorm into the convolutions and serves ``noisy_phase`` denoising.
"""

from __future__ import annotations

import argparse

SAMPLE_RATE = 8000


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HTTP denoising service (CUDA)")
    p.add_argument("--noise_type", default="white",
                   choices=["white", "urban", "reverb", "noise_cancellation",
                            "mixed"],
                   help="which specialised checkpoint to serve")
    p.add_argument("--saved_models_dir", default="./saved_models")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--bucket_seconds", type=float, default=2.0,
                   help="requests are padded to multiples of this many "
                   "seconds so the device sees few shapes")
    p.add_argument("--max_seconds", type=float, default=60.0)
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16",
                   help="compute dtype of the folded U-Net")
    p.add_argument(
        "--bypass_db", type=float, default=None,
        help="identity-bypass gate: clips whose relative model-change "
        "energy is below -bypass_db are returned verbatim. Off unless set; "
        "<=0 disables.",
    )
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from audiodenoiser_torch.eval.runner import DenoiserRunner, load_model_for_noise
    from audiodenoiser_torch.serve import DenoiseService, make_http_server

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    model = load_model_for_noise(args.noise_type, args.saved_models_dir, dtype=dtype)
    runner = DenoiserRunner(model)
    print("Warming up (building kernels, first-bucket batches)...")
    service = DenoiseService(
        runner,
        sample_rate=SAMPLE_RATE,
        bucket_samples=int(args.bucket_seconds * SAMPLE_RATE),
        max_seconds=args.max_seconds,
        warmup=True,
        bypass_db=args.bypass_db,
    )
    server = make_http_server(service, args.host, args.port)
    print(f"Serving unet_denoiser_{args.noise_type} on "
          f"http://{args.host}:{args.port} ({torch.cuda.get_device_name()})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
