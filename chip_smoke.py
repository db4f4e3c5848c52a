#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

from the root of a checkout. Phases, each fatal on failure:

1. print the card's name and power limit; build every CUDA kernel from
   ``audiodenoiser_torch/csrc`` (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card and time
   kernel, plain version and one library call beside the kernel's lower
   bound: K1/K2 at the bench shape (256 clips of 2 s) and a ragged one (3
   clips of 3.1 s); K3 at the four upsamplings of a batch-16 training step
   and of a batch-256 bench batch, in bf16 and fp32, forward and backward;
   K4 (overlap-add, a standalone op that no path calls) at the bench shape,
   a ragged one at hop 100 and batch 10 at hop 512;
3. serve HTTP requests through the full-width 31,042,369-parameter
   BN-folded bf16 U-Net (``DenoiseService`` + ``make_http_server``) and
   check each answer against a direct ``DenoiserRunner`` call; K1 and K2's
   launch counters must rise during the requests, K4's must stay 0;
3b. the recommended deployment, the full-width 31,043,586-parameter
   residual ``ComplexMaskUNet``: seeded weights written with the port's
   ``export_model`` as ``mask_denoiser_mixed.ckpt`` + sidecar and read back
   bit-equal, served by ``cli.serve.build_server`` (``--model complex_mask
   --noise_type mixed``: ``load_model_for_noise(stem="mask_denoiser")``
   folded to bf16, warm-up, a WOLA streamer), 5 ``/denoise`` requests in
   ``complex_mask`` mode each against a direct runner call, one
   ``/stream`` session fed 3 s in ragged packets and flushed (as many
   samples out as in); K1 and K2 counted, K4 0;
4. run the serving slice in fp32 on the card (kernels) and on the CPU
   (plain versions) for one 2 s clip and compare; the same for the mask
   slice, and a streamed fp32 mask session against the offline
   ``StreamingDenoiser.denoise`` of the same signal;
5. one full-width fp32 training step (mixer with K1, U-Net with K3) on the
   card against the CPU from the same weights, chunks and noise draws (the
   two featurizations within one float16 rounding, then one batch for both);
6. ``train.loop.fit`` of the full-width bf16 ``UNet(pallas_deconv=True)``
   on the on-device mixer: 2 epochs of 10 steps at batch 16, K1 and K3
   counted (K4 0), the export served, then the steady step rate and its device
   profile; and ``python -m audiodenoiser_torch.cli.train`` on wavs;
7. measure throughput with ``eval.bench.run_bench`` at batch 256, folded,
   with ``pallas_deconv`` (K1, K2 and K3 counted) and in ``complex_mask``
   mode (K1 and K2 counted).

Before the last line come one JSON object listing every kernel with its
launches on its path, error and times, then the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``. Without a GPU,
or without the package beside it, the script fails before printing any
result.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
PARAMS_FULL = 31_042_369
PARAMS_MASK = 31_043_586  # ComplexMaskUNet: 3 input channels, 2 output channels
SR, N_FFT, HOP = 8000, 512, 128
KERNEL_TOL = 1e-4  # max |kernel - plain| <= KERNEL_TOL * max |plain|
SERVE_TOL = 1e-4   # relative L2, service vs direct call on the same batch:
                   # 16-bit PCM rounding only
SLICE_TOL = 1e-4   # relative L2, fp32 card vs CPU (tests/test_torch_runner.py)
# H100 SXM peaks from NVIDIA's data sheet (dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# K4 shapes (B, T, n_fft, hop): the bench shape, a ragged one whose hop
# does not divide n_fft, and one with no overlap at all
OLA_SHAPES = ((256, 126, 512, 128), (3, 41, 512, 100), (10, 20, 512, 512))
# K3 shapes (B, Cin, H, W, Cout): the four upsamplings of a training step
# (batch 16, crop 256 x 64) and of a bench batch (256 clips of 2 s, 257 x 126)
DECONV_TRAIN = ((16, 1024, 16, 4, 512), (16, 512, 32, 8, 256),
                (16, 256, 64, 16, 128), (16, 128, 128, 32, 64))
DECONV_BENCH = ((256, 1024, 16, 7, 512), (256, 512, 32, 15, 256),
                (256, 256, 64, 31, 128), (256, 128, 128, 63, 64))
TRAIN_TOL = 1e-4  # fp32 training step, card vs CPU: loss, grad norm, BN stats


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def stft_bound_ms(batch: int, n_frames: int, signal_len: int) -> tuple[float, str]:
    """Least time for one STFT or iSTFT at these shapes, whatever the
    algorithm: the larger of its bytes (signal + re/im planes + window,
    each moved once) over the memory rate and the operations of an FFT
    (2.5*n_fft*log2(n_fft) per real frame, plus the window multiply) over
    the fp32 non-tensor rate."""
    n_freq = N_FFT // 2 + 1
    nbytes = 4 * batch * (signal_len + 2 * n_freq * n_frames) + 4 * N_FFT
    flops = batch * n_frames * (2.5 * N_FFT * math.log2(N_FFT) + N_FFT)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def direct_dft_ms(batch: int, n_frames: int) -> float:
    """The floor of the kernels' own algorithm, a direct DFT (re and im,
    one FMA each per sample and bin): a reference, not the bound."""
    flops = 4 * N_FFT * (N_FFT // 2 + 1) * n_frames * batch
    return flops / PEAK_FP32_FLOPS * 1e3


def phase_kernels(torch, rng):
    """Phase 2: each kernel against its plain version; returns the bench-
    shape rows of the kernels line (launches filled in by phase 3)."""
    import torch.nn.functional as F

    from audiodenoiser_torch.dsp.stft import overlap_add
    from audiodenoiser_torch.dsp.window import hann_window
    from audiodenoiser_torch.ops.cuda import istft_kernel, istft_plain, stft_kernel, stft_plain

    dev = torch.device("cuda")
    w = torch.from_numpy(hann_window(N_FFT)).to(dev)
    rows = {}
    for label, batch, seconds in (("bench", 256, 2.0), ("ragged", 3, 3.1)):
        n = int(round(seconds * SR))
        audio = torch.from_numpy(
            (0.2 * rng.standard_normal((batch, n))).astype("float32")).to(dev)
        x = F.pad(audio, (N_FFT // 2, N_FFT // 2)).contiguous()  # centre pad
        n_frames = 1 + (x.shape[1] - N_FFT) // HOP

        spec_k = stft_kernel(x, w, N_FFT, HOP)
        spec_p = stft_plain(x, w, N_FFT, HOP)
        torch.cuda.synchronize()
        check(spec_k.shape == spec_p.shape == (batch, N_FFT // 2 + 1, n_frames),
              f"K1 shape {tuple(spec_k.shape)} at {label}")
        ref = torch.view_as_real(spec_p)
        err1 = (torch.view_as_real(spec_k) - ref).abs().max().item()
        scale1 = ref.abs().max().item()

        parts = torch.view_as_real(spec_p)
        re, im = parts[..., 0], parts[..., 1]
        y_k = istft_kernel(re, im, w, N_FFT, HOP)
        y_p = istft_plain(re, im, w, N_FFT, HOP)
        torch.cuda.synchronize()
        check(y_k.shape == y_p.shape == (batch, (n_frames - 1) * HOP + N_FFT),
              f"K2 shape {tuple(y_k.shape)} at {label}")
        err2 = (y_k - y_p).abs().max().item()
        scale2 = y_p.abs().max().item()
        print(f"[kernels] {label} B={batch} L={x.shape[1]} T={n_frames}: "
              f"K1 max_abs_err={err1:.3e} max_rel_err={err1 / scale1:.3e}; "
              f"K2 max_abs_err={err2:.3e} max_rel_err={err2 / scale2:.3e}",
              flush=True)
        check(err1 <= KERNEL_TOL * scale1, f"K1 disagrees with plain at {label}")
        check(err2 <= KERNEL_TOL * scale2, f"K2 disagrees with plain at {label}")
        if label != "bench":
            continue

        def library_istft():
            spec = torch.complex(re, im).transpose(-1, -2)
            frames = torch.fft.irfft(spec, n=N_FFT, dim=-1) * w
            return F.fold(frames.transpose(1, 2), (1, y_p.shape[1]), (1, N_FFT),
                          stride=(1, HOP))

        ref_fold = library_istft().reshape(batch, -1)
        check((ref_fold - overlap_add(torch.fft.irfft(
            spec_p.transpose(-1, -2), n=N_FFT, dim=-1) * w, HOP)).abs().max().item()
            <= KERNEL_TOL * scale2, "F.fold yardstick disagrees")
        timings = {
            "stft_kernel": (
                time_ms(lambda: stft_kernel(x, w, N_FFT, HOP)),
                time_ms(lambda: stft_plain(x, w, N_FFT, HOP)),
                time_ms(lambda: torch.stft(x, N_FFT, HOP, window=w, center=False,
                                           return_complex=True)),
                err1),
            "istft_kernel": (
                time_ms(lambda: istft_kernel(re, im, w, N_FFT, HOP)),
                time_ms(lambda: istft_plain(re, im, w, N_FFT, HOP)),
                time_ms(library_istft),
                err2),
        }
        bound, bound_by = stft_bound_ms(batch, n_frames, x.shape[1])
        dft_ms = direct_dft_ms(batch, n_frames)
        replaces = {"stft_kernel": "audiodenoiser_tpu/ops/pallas/stft_kernel.py:117",
                    "istft_kernel": "audiodenoiser_tpu/ops/pallas/istft_kernel.py:138"}
        for name, (ms, plain_ms, lib_ms, err) in timings.items():
            rows[name] = {
                "name": name, "route": "cuda",
                "source": f"audiodenoiser_torch/csrc/{name}.cu",
                "replaces": replaces[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            }
            print(f"[kernels] {name} bench: kernel_ms={ms:.4f} plain_ms="
                  f"{plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} "
                  f"({bound_by}) direct_dft_ms={dft_ms:.4f}", flush=True)
    return rows


def _wav(audio) -> bytes:
    from audiodenoiser_torch.data.wav_io import write_wav

    buf = io.BytesIO()
    write_wav(buf, audio, SR)
    return buf.getvalue()


def _post(url: str, body: bytes, query: str = ""):
    from audiodenoiser_torch.data.wav_io import read_wav

    req = urllib.request.Request(f"{url}/denoise{query}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        check(r.status == 200, f"POST /denoise returned {r.status}")
        return read_wav(io.BytesIO(r.read()))[0]


class _GatedRunner:
    """Delegates to the real runner. Once ``close()`` is called, the next
    batch holds the dispatcher (``holding`` is set) until ``open()``, so
    that later requests queue up behind it."""

    def __init__(self, runner):
        self.runner, self.device = runner, runner.device
        self.gate = threading.Event()
        self.gate.set()
        self.holding = threading.Event()
        self.batch_sizes = []

    def close(self):
        self.gate.clear()

    def open(self):
        self.gate.set()

    def denoise_audio(self, audio, **kw):
        if not self.gate.is_set():
            self.holding.set()
            self.gate.wait(timeout=60)
        self.batch_sizes.append(int(audio.shape[0]))
        return self.runner.denoise_audio(audio, **kw)


def phase_serve(torch, rng, rows, device="cuda"):
    """Phase 3: the main path, HTTP requests through the full-width model."""
    import numpy as np

    from audiodenoiser_torch.data.wav_io import read_wav
    from audiodenoiser_torch.device import device_name
    from audiodenoiser_torch.eval.bench import build_runner
    from audiodenoiser_torch.models import UNet, count_params
    from audiodenoiser_torch.ops.cuda import istft_kernel, reset_launch_counts, stft_kernel
    from audiodenoiser_torch.serve import DenoiseService, make_http_server

    check(count_params(UNet()) == PARAMS_FULL,
          f"parameter count {count_params(UNet())} != {PARAMS_FULL}")
    # seeded Flax-layout weights with random BN statistics, carried across
    # by state_dict_from_flax and folded to bf16
    runner = build_runner(0, torch.bfloat16, device=device)
    gated = _GatedRunner(runner)
    service = DenoiseService(gated, sample_rate=SR, bucket_samples=2 * SR,
                             max_seconds=10.0)
    server = make_http_server(service, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        clips = {s: np.clip(0.2 * rng.standard_normal(int(round(s * SR))), -1, 1)
                 .astype(np.float32) for s in (0.5, 2.0, 3.1)}
        pair = [np.clip(0.2 * rng.standard_normal(2 * SR), -1, 1).astype(np.float32)
                for _ in range(2)]
        # what the service decodes is the int16-quantised clip
        sent = {k: read_wav(io.BytesIO(_wav(v)))[0] for k, v in clips.items()}
        sent_pair = [read_wav(io.BytesIO(_wav(v)))[0] for v in pair]

        reset_launch_counts()
        t0 = time.perf_counter()
        answers = {s: _post(url, _wav(clips[s])) for s in (0.5, 2.0)}
        # 3.1 s holds the dispatcher at the gate while the 2 s pair queues
        # behind it, so the pair coalesces into one batch of 2
        results = {}

        def post(key, body):
            results[key] = _post(url, body)

        gated.close()
        threads = [threading.Thread(target=post, args=(3.1, _wav(clips[3.1])))]
        threads[0].start()
        check(gated.holding.wait(timeout=60), "the 3.1 s request never dispatched")
        for i, clip in enumerate(pair):
            threads.append(threading.Thread(target=post, args=(f"pair{i}", _wav(clip))))
            threads[-1].start()
        deadline = time.monotonic() + 30
        while "adt_queue_depth 2" not in service.metrics_text():
            check(time.monotonic() < deadline, "the 2 s pair never queued")
            time.sleep(0.01)
        gated.open()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), "a request never finished")
        serve_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in (stft_kernel, istft_kernel)}
        answers.update(results)
        print(f"[serve] 5 requests in {serve_s:.3f} s, batch sizes "
              f"{gated.batch_sizes}, kernel launches {launches}", flush=True)
        check(2 in gated.batch_sizes, "the concurrent 2 s pair did not coalesce")
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the main path")
            rows[name]["launches"] = n
        count_off_path(rows, "the noisy-phase requests")

        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok"
              and health["device"] == device_name(runner.device),
              f"/healthz: {health}")
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        check("adt_requests_total 5" in metrics, "/metrics lacks 5 requests")
        print(f"[serve] /healthz {health}", flush=True)

        # each answer against a direct call on the batch the service formed:
        # the clip zero-padded to its bucket, batched with its batch-mate
        batches = [[sent[0.5]], [sent[2.0]], [sent[3.1]], sent_pair]
        keys = [[0.5], [2.0], [3.1], ["pair0", "pair1"]]
        for group, names in zip(batches, keys):
            bucket = service._bucket_len(len(group[0]))
            padded = np.zeros((len(group), bucket), np.float32)
            for i, clip in enumerate(group):
                padded[i, : len(clip)] = clip
            direct_batch = runner.denoise_audio(torch.from_numpy(padded))
            for i, (key, clip) in enumerate(zip(names, group)):
                check_answer(key, clip, answers[key], direct_batch[i, : len(clip)])
        # measured, not checked: in bf16 a clip's answer depends on the
        # batch it ran in, because cuDNN picks other kernels per batch size
        for key, clip in zip(keys[-1], sent_pair):
            alone = runner.denoise_audio(torch.from_numpy(clip[None]))[0]
            alone = alone.float().cpu().numpy()
            gap = np.linalg.norm(answers[key] - alone) / (np.linalg.norm(alone) + 1e-12)
            print(f"[serve] {key}: bf16 batch-composition gap, served in a pair "
                  f"vs alone: rel_err {gap:.3e}", flush=True)
    finally:
        server.shutdown()
        server.server_close()


def count_off_path(rows, run: str) -> None:
    """K4 is on no path, as B4 is in the JAX package: read its launch
    count after a main path's run, record it and require 0."""
    from audiodenoiser_torch.ops.cuda import overlap_add_kernel

    n = overlap_add_kernel.launches
    print(f"[launches] overlap_add_kernel: {n} during {run}", flush=True)
    check(n == 0, f"overlap_add_kernel launched {n} times during {run}")
    rows["overlap_add_kernel"]["launches"] = rows["overlap_add_kernel"].get("launches", 0) + n


def check_answer(key, clip, out, direct):
    import numpy as np

    from audiodenoiser_torch.data.wav_io import read_wav

    check(out.shape == clip.shape, f"{key}: length {out.shape} != {clip.shape}")
    check(bool(np.isfinite(out).all()), f"{key}: non-finite output")
    # the same 16-bit PCM encoding the service applies to its answer
    direct = read_wav(io.BytesIO(_wav(direct.float().cpu().numpy())))[0]
    rel = np.linalg.norm(out - direct) / (np.linalg.norm(direct) + 1e-12)
    print(f"[serve] {key}: {len(clip)} samples, output rms "
          f"{np.sqrt(np.mean(direct ** 2)):.4f}, rel_err vs direct runner "
          f"call {rel:.3e}", flush=True)
    check(rel < SERVE_TOL, f"{key}: service disagrees with the runner")


def phase_slice_fp32(torch, rng):
    """Phase 4: the whole slice in fp32, card (kernels) against CPU (plain)."""
    import numpy as np

    from audiodenoiser_torch.eval.bench import build_runner

    outs = {}
    clip = np.clip(0.2 * rng.standard_normal((1, 2 * SR)), -1, 1).astype(np.float32)
    for dev in ("cuda", "cpu"):
        runner = build_runner(1, torch.float32, device=dev)
        # fp32 convolutions in full fp32 on the card, not TF32
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            outs[dev] = runner.denoise_audio(torch.from_numpy(clip)).cpu().numpy()
    a, b = outs["cuda"], outs["cpu"]
    rel = float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))
    print(f"[slice fp32] card (kernels) vs CPU (plain): rel_err={rel:.3e} "
          f"max_abs_err={np.abs(a - b).max():.3e}", flush=True)
    check(np.isfinite(a).all() and rel < SLICE_TOL, "fp32 slice card vs CPU")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def phase_mask_serve(torch, rng, rows):
    """Phase 3b: the recommended deployment end to end, from a ``.ckpt``
    the port wrote, through ``cli.serve``'s own server, to HTTP answers and
    one stream session. Returns the seeded variables for phase 4b."""
    import numpy as np

    from audiodenoiser_torch.cli.serve import build_server, parse_args
    from audiodenoiser_torch.data.wav_io import read_wav
    from audiodenoiser_torch.models import random_flax_variables
    from audiodenoiser_torch.ops.cuda import istft_kernel, reset_launch_counts, stft_kernel
    from audiodenoiser_torch.train.checkpoints import export_model, load_exported

    variables = random_flax_variables(4, in_channels=3, out_channels=2)
    n_params = sum(a.size for a in _leaves(variables["params"]).values())
    check(n_params == PARAMS_MASK, f"mask parameter count {n_params} != {PARAMS_MASK}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mask_")
    server = None
    try:
        path = os.path.join(tmp, "mask_denoiser_mixed.ckpt")
        t0 = time.perf_counter()
        export_model(path, variables["params"], variables["batch_stats"])
        with open(os.path.join(tmp, "mask_denoiser_mixed.json"), "w") as f:
            json.dump({"width_mult": 1.0, "mask_bound": 2.0, "residual": True}, f)
        back = load_exported(path)
        want, got = _leaves(variables), _leaves(back)
        check(want.keys() == got.keys() and all(
            want[k].dtype == got[k].dtype and want[k].shape == got[k].shape
            and want[k].tobytes() == got[k].tobytes() for k in want),
            "the .ckpt did not read back bit-equal")
        write_s = time.perf_counter() - t0
        # the deployment as `python -m audiodenoiser_torch.cli.serve` builds it:
        # load_model_for_noise(stem="mask_denoiser") folded to bf16, warm-up,
        # a WOLA streamer with a chunk of one 2 s bucket
        service, server, name = build_server(parse_args([
            "--model", "complex_mask", "--noise_type", "mixed", "--saved_models_dir", tmp,
            "--port", "0", "--max_seconds", "10"]))
        runner = service.runner
        check(name == "mask_denoiser_mixed" and service.default_mode == "complex_mask"
              and runner.model.mask_bound == 2.0 and runner.model.mask_residual
              and runner.device.type == "cuda", "cli.serve built the wrong deployment")
        print(f"[mask] {n_params} parameters; .ckpt of {os.path.getsize(path)} bytes "
              f"written and read back bit-equal over {len(got)} arrays in {write_s:.2f} s; "
              f"cli.serve loaded it folded to bf16 and warmed up in "
              f"{time.perf_counter() - t0 - write_s:.2f} s", flush=True)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        threading.Thread(target=server.serve_forever, daemon=True).start()

        clips = [np.clip(0.2 * rng.standard_normal(int(round(s * SR))), -1, 1)
                 .astype(np.float32) for s in (0.5, 1.3, 2.0, 2.7, 3.1)]
        signal = np.clip(0.2 * rng.standard_normal(3 * SR), -1, 1).astype(np.float32)
        reset_launch_counts()
        t0 = time.perf_counter()
        answers = [_post(url, _wav(c), "?mode=complex_mask") for c in clips]
        info = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"{url}/stream/start", data=b"", method="POST"), timeout=300).read())
        check(info["latency_samples"] == 2 * SR and info["format"] == "f32le",
              f"/stream/start: {info}")
        streamed, start = [], 0
        for n in (1000, 4000, 7000, 12000, "flush"):
            tail = "/flush" if n == "flush" else ""
            body = b"" if n == "flush" else signal[start:start + n].astype("<f4").tobytes()
            start += 0 if n == "flush" else n
            req = urllib.request.Request(f"{url}/stream/{info['session']}{tail}",
                                         data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                streamed.append(np.frombuffer(r.read(), "<f4"))
        serve_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in (stft_kernel, istft_kernel)}
        lens = [len(p) for p in streamed]
        out = np.concatenate(streamed)
        print(f"[mask] 5 requests and a 3 s stream in {serve_s:.3f} s; stream packets "
              f"in (1000, 4000, 7000, 12000, flush) -> out {lens}, total {len(out)} of "
              f"{len(signal)}; kernel launches {launches}", flush=True)
        check(len(out) == len(signal) and bool(np.isfinite(out).all()),
              "the stream session did not return as many samples as it was fed")
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the mask path")
        count_off_path(rows, "the mask deployment's requests and stream")
        for clip, answer in zip(clips, answers):
            sent = read_wav(io.BytesIO(_wav(clip)))[0]
            padded = np.zeros((1, service._bucket_len(len(sent))), np.float32)
            padded[0, : len(sent)] = sent
            direct = runner.denoise_audio(torch.from_numpy(padded))[0, : len(sent)]
            check_answer(f"mask {len(clip) / SR:.1f} s", sent, answer, direct)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    return variables


def phase_mask_fp32(torch, rng, variables):
    """Phase 4b: the mask slice in fp32, card (kernels) against CPU
    (plain); a streamed fp32 session against the offline WOLA denoise of
    the same signal; the bf16 streaming-vs-offline gap, printed only."""
    import numpy as np

    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.eval.streaming import StreamingDenoiser
    from audiodenoiser_torch.models import (
        ComplexMaskUNet,
        fold_for_inference,
        load_flax_variables,
    )

    feats = tuple(variables["params"][f"down{i}"]["conv0"]["kernel"].shape[-1]
                  for i in range(4))
    bottleneck = variables["params"]["bottleneck"]["conv0"]["kernel"].shape[-1]

    def runner(dev, dtype):
        model = load_flax_variables(ComplexMaskUNet(residual=True, features=feats,
                                                    bottleneck=bottleneck), variables)
        return DenoiserRunner(fold_for_inference(model.eval(), dtype), device=dev)

    clip = np.clip(0.2 * rng.standard_normal((1, 2 * SR)), -1, 1).astype(np.float32)
    signal = np.clip(0.2 * rng.standard_normal(3 * SR), -1, 1).astype(np.float32)
    outs = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for dev in ("cuda", "cpu"):
            outs[dev] = runner(dev, torch.float32).denoise_audio(
                torch.from_numpy(clip)).cpu().numpy()
        rel = float(np.linalg.norm(outs["cuda"] - outs["cpu"])
                    / (np.linalg.norm(outs["cpu"]) + 1e-12))
        print(f"[mask fp32] card (kernels) vs CPU (plain): rel_err={rel:.3e}", flush=True)
        check(np.isfinite(outs["cuda"]).all() and rel < SLICE_TOL, "fp32 mask slice card vs CPU")
        gaps = {}
        for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            streamer = StreamingDenoiser(runner("cuda", dtype), chunk_samples=2 * SR)
            sess = streamer.session()
            parts = [sess.process(signal[a:b]) for a, b in
                     ((0, 1000), (1000, 5000), (5000, 12000), (12000, 24000))]
            online = np.concatenate(parts + [sess.flush()])
            offline = streamer.denoise(signal)
            check(online.shape == offline.shape == signal.shape, f"{label} stream length")
            gaps[label] = float(np.linalg.norm(online - offline)
                                / (np.linalg.norm(offline) + 1e-12))
    print(f"[mask fp32] streamed session vs offline StreamingDenoiser.denoise: "
          f"rel_err={gaps['fp32']:.3e}; bf16 (not checked): rel_err={gaps['bf16']:.3e}",
          flush=True)
    check(gaps["fp32"] < SLICE_TOL, "fp32 streaming disagrees with offline")


def deconv_bound_ms(shapes, itemsize: int) -> tuple[float, str]:
    """Least time for these K3 calls together: the larger of their bytes
    (x read once, out written once, plus the 2x2 weights in the compute
    dtype and the fp32 bias) over the memory rate and their multiply-adds
    (2*B*H*W*4*Cin*Cout) over the dense bf16 tensor rate."""
    nbytes = flops = 0
    for b, cin, h, w, cout in shapes:
        nbytes += itemsize * (b * h * w * cin + 4 * b * h * w * cout + 4 * cin * cout) + 4 * cout
        flops += 2 * b * h * w * 4 * cin * cout
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_deconv(torch, rng):
    """Phase 2, K3: the kernel against its plain version at the training-step
    and bench shapes, bf16 and fp32, forward and backward; times in bf16.
    Returns the kernels-line row, timed over one training step's four
    upsamplings (launches filled in by the training phase)."""
    import torch.nn.functional as F

    from audiodenoiser_torch.ops.cuda import (
        conv_transpose_2x2,
        conv_transpose_2x2_plain,
        deconv_kernel,
    )

    dev = torch.device("cuda")
    totals = {"train": [0.0, 0.0, 0.0], "bench": [0.0, 0.0, 0.0]}
    train_err = 0.0
    for label, shapes in (("train", DECONV_TRAIN), ("bench", DECONV_BENCH)):
        for b, cin, h, w, cout in shapes:
            x32 = torch.from_numpy(rng.standard_normal((b, h, w, cin), dtype="float32")).to(dev)
            x32 = x32.permute(0, 3, 1, 2)  # logical NCHW, channels_last memory
            wt = torch.from_numpy((rng.standard_normal((cin, cout, 2, 2)) / math.sqrt(cin))
                                  .astype("float32")).to(dev)
            bias = torch.from_numpy(rng.standard_normal(cout).astype("float32")).to(dev)
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                ours = deconv_kernel(x, wt, bias)
                ref = conv_transpose_2x2_plain(x.float(), wt.to(dtype).float(), bias)
                torch.cuda.synchronize()
                check(ours.shape == (b, cout, 2 * h, 2 * w) and ours.dtype == dtype
                      and ours.is_contiguous(memory_format=torch.channels_last),
                      f"K3 output {tuple(ours.shape)} {ours.dtype} at {label}")
                err = (ours.float() - ref).abs().max().item()
                scale = ref.abs().max().item()
                tol = 1e-5 if dtype == torch.float32 else 1e-2
                errs[str(dtype).split(".")[-1]] = (err, err / scale)
                check(err <= tol * scale, f"K3 {dtype} disagrees with plain at "
                      f"{(b, cin, h, w, cout)}: {err:.3e} of {scale:.3e}")
                if dtype == torch.bfloat16 and label == "train":
                    train_err = max(train_err, err)
                del ours, ref
            # backward in fp32: the Function (K3 forward) against autograd
            # through the plain version, TF32 off
            grads = []
            for fn in (conv_transpose_2x2, conv_transpose_2x2_plain):
                xg, wg, bg = (t.detach().clone().requires_grad_() for t in (x32, wt, bias))
                with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                    (fn(xg, wg, bg).square() * 0.5).sum().backward()
                grads.append((xg.grad, wg.grad, bg.grad))
            gerr = max(((a - r).norm() / r.norm()).item() for a, r in zip(*grads))
            check(gerr <= 1e-4, f"K3 backward disagrees at {(b, cin, h, w, cout)}: {gerr:.3e}")
            del grads
            xb, wb, bb = x32.to(torch.bfloat16), wt.to(torch.bfloat16), bias.to(torch.bfloat16)
            wb_cl = wb.contiguous(memory_format=torch.channels_last)
            ms = time_ms(lambda: deconv_kernel(xb, wt, bias))
            plain_ms = time_ms(lambda: conv_transpose_2x2_plain(xb, wt, bias), reps=5)
            lib_ms = time_ms(lambda: F.conv_transpose2d(xb, wb_cl, bb, stride=2))
            bound, bound_by = deconv_bound_ms([(b, cin, h, w, cout)], 2)
            for i, t in enumerate((ms, plain_ms, lib_ms)):
                totals[label][i] += t
            print(f"[kernels] deconv_kernel {label} B={b} Cin={cin} H={h} W={w} "
                  f"Cout={cout}: f32 max_rel_err={errs['float32'][1]:.3e} bf16 "
                  f"max_rel_err={errs['bfloat16'][1]:.3e} grad_rel_l2={gerr:.3e}; bf16 "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={bound:.4f} ({bound_by})", flush=True)
            del x32, xb
            torch.cuda.empty_cache()
    for label, shapes in (("train", DECONV_TRAIN), ("bench", DECONV_BENCH)):
        bound, bound_by = deconv_bound_ms(shapes, 2)
        ms, plain_ms, lib_ms = totals[label]
        print(f"[kernels] deconv_kernel {label}, four upsamplings: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} "
              f"({bound_by})", flush=True)
    bound, bound_by = deconv_bound_ms(DECONV_TRAIN, 2)
    ms, plain_ms, lib_ms = totals["train"]
    return {"name": "deconv_kernel", "route": "cuda",
            "source": "audiodenoiser_torch/csrc/deconv_kernel.cu",
            "replaces": "audiodenoiser_tpu/ops/pallas/deconv_kernel.py:117",
            "max_abs_err": train_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms}


def ola_bound_ms(batch: int, n_frames: int, n_fft: int, hop: int) -> tuple[float, str]:
    """Least time for one overlap-add: the larger of its bytes (frames read
    once, output written once) over the memory rate and its adds (one per
    frame sample) over the fp32 non-tensor rate."""
    out_len = (n_frames - 1) * hop + n_fft
    t_bytes = 4 * batch * (n_frames * n_fft + out_len) / PEAK_BYTES_PER_S * 1e3
    t_ops = batch * n_frames * n_fft / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_overlap_add(torch, rng):
    """Phase 2, K4: the kernel against its plain version at three shapes;
    times at the bench shape beside ``F.fold`` and the bound. No path of
    the port (or of the JAX package) calls it: phases 3, 3b and 6 read its
    launches and require 0."""
    import torch.nn.functional as F

    from audiodenoiser_torch.ops.cuda import overlap_add_kernel, overlap_add_plain

    dev = torch.device("cuda")
    worst = 0.0
    row = None
    for batch, n_frames, n_fft, hop in OLA_SHAPES:
        frames = torch.from_numpy(
            rng.standard_normal((batch, n_frames, n_fft), dtype="float32")).to(dev)
        ours = overlap_add_kernel(frames, hop)
        ref = overlap_add_plain(frames, hop)
        torch.cuda.synchronize()
        out_len = (n_frames - 1) * hop + n_fft
        check(ours.shape == ref.shape == (batch, out_len), f"K4 shape {tuple(ours.shape)}")
        err = (ours - ref).abs().max().item()
        scale = ref.abs().max().item()
        worst = max(worst, err)
        print(f"[kernels] overlap_add_kernel B={batch} T={n_frames} n_fft={n_fft} "
              f"hop={hop}: max_abs_err={err:.3e} max_rel_err={err / scale:.3e}", flush=True)
        check(err <= KERNEL_TOL * scale, f"K4 disagrees with plain at hop {hop}")
        if row is not None:
            continue

        def fold():
            return F.fold(frames.transpose(1, 2), (1, out_len), (1, n_fft),
                          stride=(1, hop)).reshape(batch, out_len)

        check((fold() - ref).abs().max().item() <= KERNEL_TOL * scale,
              "F.fold yardstick disagrees")
        ms = time_ms(lambda: overlap_add_kernel(frames, hop))
        plain_ms = time_ms(lambda: overlap_add_plain(frames, hop))
        lib_ms = time_ms(fold)
        bound, bound_by = ola_bound_ms(batch, n_frames, n_fft, hop)
        print(f"[kernels] overlap_add_kernel bench: kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({bound_by})",
              flush=True)
        row = {"name": "overlap_add_kernel", "route": "cuda",
               "source": "audiodenoiser_torch/csrc/overlap_add_kernel.cu",
               "replaces": "audiodenoiser_tpu/ops/pallas/overlap_add_kernel.py:58",
               "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms}
    row["max_abs_err"] = worst
    return row


def phase_train_step_fp32(torch):
    """Phase 5: one full-width fp32 training step on the card (K1 in the
    mixer, K3 forward and backward) against the CPU (plain versions), from
    the same weights, clean chunks and noise draws. The mixer's float16
    round trip can round a magnitude the other way when K1 and the CPU's
    FFT differ in the last bit, so the two featurizations are held to one
    float16 rounding, and both steps then run on the card's batch."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.models import UNet, random_flax_variables
    from audiodenoiser_torch.ops.cuda import deconv_kernel, stft_kernel
    from audiodenoiser_torch.train.bench import synth_chunks
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    chunks = synth_chunks(8, seed=1)
    variables = random_flax_variables(2)
    draws = OnDeviceMixer(chunks, "white", device="cpu").draw(
        torch.Generator().manual_seed(5), 2)
    launched = stft_kernel.launches
    batch = OnDeviceMixer(chunks, "white", device="cuda").sample_from(draws)
    check(stft_kernel.launches == launched + 1, "the card's mixer did not run K1")
    plain = OnDeviceMixer(chunks, "white", device="cpu").sample_from(draws)
    for name, a, b in zip(("noisy", "clean"), batch, plain):
        d = (a.cpu() - b).abs()
        rel = (d / b.abs().clamp_min(torch.finfo(torch.float16).tiny)).max().item()
        print(f"[train fp32] {name} features card (K1) vs CPU: {int((d > 0).sum())} of "
              f"{d.numel()} differ, max rel {rel:.3e}", flush=True)
        check(rel <= 2.0 ** -10, f"{name} features differ by more than one float16 rounding")
    got = {}
    for dev in ("cuda", "cpu"):
        noisy, clean = (t.to(dev) for t in batch)
        launched = deconv_kernel.launches
        state = create_train_state(0, UNet(pallas_deconv=True), variables=variables,
                                   device=dev)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            state, losses = train_step(state, noisy, clean)
        stats = {k: v.float().cpu() for k, v in state.model.state_dict().items()
                 if "running" in k}
        got[dev] = (float(losses.total), float(state.grad_norm), stats)
        if dev == "cuda":
            check(deconv_kernel.launches == launched + 4, "the fp32 card step did not run K3")
        del state
    (lc, gc, sc), (lp, gp, sp) = got["cuda"], got["cpu"]
    stat_err = max(((sc[k] - sp[k]).abs() / (1.0 + sp[k].abs())).max().item() for k in sp)
    print(f"[train fp32] card vs CPU: loss {lc:.6f} vs {lp:.6f} (rel {abs(lc - lp) / abs(lp):.3e}), "
          f"grad norm {gc:.6f} vs {gp:.6f} (rel {abs(gc - gp) / abs(gp):.3e}), "
          f"BN running stats max |d|/(1+|ref|) {stat_err:.3e} over {len(sp)} tensors",
          flush=True)
    check(math.isfinite(lc) and abs(lc - lp) <= TRAIN_TOL * abs(lp), "fp32 step loss")
    check(abs(gc - gp) <= TRAIN_TOL * abs(gp), "fp32 step gradient norm")
    check(stat_err <= TRAIN_TOL, "fp32 step BN running stats")


def _categories(top):
    """Device ms per step by kind of kernel, from profiler kernel names."""
    kinds = (("K3 deconv", ("deconv_bf16", "deconv_f32")), ("K1 stft", ("stft_kernel",)),
             ("optimizer", ("multi_tensor", "adam", "foreach")),
             ("convolutions", ("conv", "xmma", "cudnn", "gemm", "cutlass", "wgrad",
                               "dgrad", "sm90", "implicit")),
             ("concat", ("CatArray",)), ("fft", ("fft",)),
             ("reductions (BN stats, loss)", ("reduce",)),
             ("elementwise (BN, ReLU, casts, pads)", ("elementwise", "Elementwise")))
    out = {}
    for row in top:
        name = row["kernel"]
        kind = next((k for k, pats in kinds if any(p in name for p in pats)), "other")
        out[kind] = out.get(kind, 0.0) + row["ms"]
    return out


def phase_train_fit(torch, rows, tmp):
    """Phase 6: ``fit`` at full width in bf16 with K3 and the on-device
    mixer (K1), the export served, the steady rate and its profile."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.eval.runner import DenoiserRunner, load_model_for_noise
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.ops.cuda import deconv_kernel, reset_launch_counts, stft_kernel
    from audiodenoiser_torch.train.bench import run_train_bench, synth_chunks
    from audiodenoiser_torch.train.loop import FitConfig, create_train_state, fit

    batch, steps, val_steps, epochs = 16, 10, 2, 2
    chunks = synth_chunks(72, seed=2)
    mixer = OnDeviceMixer(chunks[:64], "white")
    val_mixer = OnDeviceMixer(chunks[64:], "white")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = FitConfig(run_name="smoke", output_path=os.path.join(tmp, "runs"), epochs=epochs,
                    batch_size=batch, precision="bf16", log_every=10)
    factory = lambda: create_train_state(0, UNet(dtype=torch.bfloat16, pallas_deconv=True))
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fit(cfg, lambda e: (mixer.sample(gen, batch) for _ in range(steps)),
              lambda: (val_mixer.sample(gen, batch) for _ in range(val_steps)),
              state_factory=factory)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k1, k3 = stft_kernel.launches, deconv_kernel.launches
    forwards = epochs * (steps + val_steps)
    print(f"[train fit] {epochs} epochs x {steps} steps at batch {batch} in {fit_s:.2f} s "
          f"(validation, export and first-step set-up included); history "
          f"{res['history']}; launches K1={k1} K3={k3}", flush=True)
    check(all(math.isfinite(h["train"]) and math.isfinite(h["val"]) for h in res["history"]),
          "non-finite loss in fit")
    check(k1 == forwards, f"K1 launched {k1} times, expected {forwards}")
    check(k3 == 4 * forwards, f"K3 launched {k3} times, expected 4 per forward")
    rows["deconv_kernel"]["launches"] = k3
    count_off_path(rows, "fit")

    saved = os.path.join(tmp, "saved")
    os.makedirs(saved, exist_ok=True)
    shutil.copyfile(res["best_path"], os.path.join(saved, "unet_denoiser_white.pth"))
    runner = DenoiserRunner(load_model_for_noise("white", saved))
    clip = torch.from_numpy(chunks[-1:])
    out = runner.denoise_audio(clip).float().cpu()
    check(out.shape == clip.shape and bool(torch.isfinite(out).all()),
          "the exported model did not denoise a clip")
    print(f"[train fit] export served: 2 s clip, output rms "
          f"{out.square().mean().sqrt().item():.4f}", flush=True)

    bench = run_train_bench(batch, steps=20, profile_iters=3)
    prof = bench.pop("profile")
    print(f"[train] steady step, mixer + forward + loss + backward + AdamW: "
          f"{json.dumps(bench)}", flush=True)
    check(math.isfinite(bench["last_loss"]), "non-finite loss in the steady steps")
    if isinstance(prof.get("device_busy_ms"), float):
        cats = _categories(prof["top"])
        print(f"[train profile] wall {prof['wall_ms']:.2f} ms/step, device busy "
              f"{prof['device_busy_ms']:.2f} ms, idle {prof['idle_share']:.3f}; by kind "
              + json.dumps({k: round(v, 4) for k, v in sorted(cats.items(),
                                                               key=lambda kv: -kv[1])}),
              flush=True)
        for row in prof["top"][:15]:
            print(f"[train profile] {row['ms']:.4f} ms {row['share']:.3f} {row['kernel']}",
                  flush=True)
    else:
        print(f"[train profile] {prof}", flush=True)


def _write_wav_dir(path: str, n_files: int):
    from audiodenoiser_torch.data.wav_io import write_wav
    from audiodenoiser_torch.train.bench import synth_chunks

    os.makedirs(path, exist_ok=True)
    for i, chunk in enumerate(synth_chunks(2 * n_files, seed=3).reshape(n_files, -1)):
        write_wav(os.path.join(path, f"clean_{i}.wav"), chunk, SR)


def phase_train_cli(tmp):
    """Phase 6b: ``python -m audiodenoiser_torch.cli.train`` on the card."""
    data = os.path.join(tmp, "wavs")
    _write_wav_dir(os.path.join(data, "clean"), 12)
    export = os.path.join(tmp, "cli_saved")
    cmd = [sys.executable, "-m", "audiodenoiser_torch.cli.train", "--base_dataset_path", data,
           "--pipeline", "on_device", "--noise_type", "white", "--epochs", "1",
           "--steps_per_epoch", "3", "--output_path", os.path.join(tmp, "cli_runs"),
           "--export_dir", export]
    env = {**os.environ, "PYTHONPATH": HERE}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-6:]
    for line in tail:
        print(f"[train cli] {line}", flush=True)
    check(proc.returncode == 0, f"cli.train exited {proc.returncode}")
    check(os.path.exists(os.path.join(export, "unet_denoiser_white.pth")),
          "cli.train wrote no export")
    print(f"[train cli] exit 0 in {time.perf_counter() - t0:.1f} s, export written", flush=True)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(HERE, "audiodenoiser_torch", "csrc")):
        fail("audiodenoiser_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import numpy as np

    from audiodenoiser_torch.eval.bench import card_info, run_bench
    from audiodenoiser_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()  # nvidia-smi's "name, power.limit"
    check(not card.startswith("not available"), f"nvidia-smi: {card}")
    print(f"[card] {card}", flush=True)
    build_s = build.build_all()
    print(f"[build] {len(build.sources())} kernels built in {build_s:.2f} s", flush=True)
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    from audiodenoiser_torch.ops.cuda import KERNELS, reset_launch_counts

    rng = np.random.default_rng(0)
    rows = phase_kernels(torch, rng)
    rows["deconv_kernel"] = phase_deconv(torch, rng)
    rows["overlap_add_kernel"] = phase_overlap_add(torch, rng)
    phase_serve(torch, rng, rows)
    mask_variables = phase_mask_serve(torch, rng, rows)
    phase_slice_fp32(torch, rng)
    phase_mask_fp32(torch, rng, mask_variables)
    phase_train_step_fp32(torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_train_fit(torch, rows, tmp)
        phase_train_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bench = run_bench(batch_size=256, clip_seconds=2.0, iters=20, profile_iters=3)
    print(f"[bench] {json.dumps(bench)}", flush=True)
    check(bench["value"] > 0, "bench measured nothing")
    reset_launch_counts()
    bench_k3 = run_bench(batch_size=256, clip_seconds=2.0, iters=10, profile_iters=3,
                         pallas_deconv=True)
    launches = {k.__name__: k.launches for k in KERNELS[:3]}
    print(f"[bench pallas_deconv] {json.dumps(bench_k3)}; launches {launches}", flush=True)
    check(bench_k3["value"] > 0 and all(n > 0 for n in launches.values()),
          "the pallas_deconv bench did not run through K1, K2 and K3")
    reset_launch_counts()
    bench_mask = run_bench(batch_size=256, clip_seconds=2.0, iters=20, profile_iters=3,
                           mode="complex_mask")
    launches = {k.__name__: k.launches for k in KERNELS[:2]}
    print(f"[bench complex_mask] {json.dumps(bench_mask)}; launches {launches}", flush=True)
    check(bench_mask["value"] > 0 and all(n > 0 for n in launches.values()),
          "the complex_mask bench did not run through K1 and K2")
    print(f"[bench] folded {bench['value']:.1f} frames/s ({bench['batch_ms']:.2f} ms a "
          f"batch) vs live-BN with K3 {bench_k3['value']:.1f} frames/s "
          f"({bench_k3['batch_ms']:.2f} ms) vs folded complex_mask "
          f"{bench_mask['value']:.1f} frames/s ({bench_mask['batch_ms']:.2f} ms)", flush=True)

    check(all("launches" in r for r in rows.values()), "a kernel's launches were not read")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
