#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

from the root of a checkout. Phases, each fatal on failure:

1. print the card's name and power limit; build every CUDA kernel from
   ``audiodenoiser_torch/csrc`` (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card, at the
   bench shape (256 clips of 2 s) and a ragged one (3 clips of 3.1 s), and
   time kernel, plain version and one library call beside the kernel's
   lower bound;
3. serve HTTP requests through the full-width 31,042,369-parameter
   BN-folded bf16 U-Net (``DenoiseService`` + ``make_http_server``) and
   check each answer against a direct ``DenoiserRunner`` call; the kernels'
   launch counters must rise during the requests;
4. run the whole slice in fp32 on the card (kernels) and on the CPU
   (plain versions) for one 2 s clip and compare;
5. measure throughput with ``eval.bench.run_bench`` at batch 256.

Before the last line come one JSON object listing every kernel with its
launches on the main path, error and times, then the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``. Without a GPU, or without the package
beside it, the script fails before printing any result.
"""

from __future__ import annotations

import io
import json
import math
import os
import sys
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
PARAMS_FULL = 31_042_369
SR, N_FFT, HOP = 8000, 512, 128
KERNEL_TOL = 1e-4  # max |kernel - plain| <= KERNEL_TOL * max |plain|
SERVE_TOL = 1e-4   # relative L2, service vs direct call on the same batch:
                   # 16-bit PCM rounding only
SLICE_TOL = 1e-4   # relative L2, fp32 card vs CPU (tests/test_torch_runner.py)
# H100 SXM peaks from NVIDIA's data sheet (dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


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
                "replaces": replaces[name], "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
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


def _post(url: str, body: bytes):
    from audiodenoiser_torch.data.wav_io import read_wav

    req = urllib.request.Request(f"{url}/denoise", data=body, method="POST")
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
    from audiodenoiser_torch.ops.cuda import KERNELS, reset_launch_counts
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
        launches = {k.__name__: k.launches for k in KERNELS}
        answers.update(results)
        print(f"[serve] 5 requests in {serve_s:.3f} s, batch sizes "
              f"{gated.batch_sizes}, kernel launches {launches}", flush=True)
        check(2 in gated.batch_sizes, "the concurrent 2 s pair did not coalesce")
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the main path")
            rows[name]["launches"] = n

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

    rng = np.random.default_rng(0)
    rows = phase_kernels(torch, rng)
    phase_serve(torch, rng, rows)
    phase_slice_fp32(torch, rng)
    bench = run_bench(batch_size=256, clip_seconds=2.0, iters=20, profile_iters=3)
    print(f"[bench] {json.dumps(bench)}", flush=True)
    check(bench["value"] > 0, "bench measured nothing")

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
