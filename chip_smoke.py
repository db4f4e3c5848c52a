#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

from the root of a checkout. Phases, each fatal on failure:

1. print the card's name and power limit; build every CUDA kernel from
   ``audiodenoiser_torch/csrc`` (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card and time
   kernel, plain version and one library call beside the kernel's lower
   bound (``ms``: CUDA events per call, host launch cost included;
   ``device_ms``: the profiler's device time beside it): K1/K2 at the bench shape (256 clips of 2 s), a
   ragged one (3 clips of 3.1 s), a stream window (1 clip of 2 s), the
   ticks of pools of 8 and 64 streams (8 and 64 windows of 2 s), and
   uncentred, the training set's device batch (256 chunks of 2 s) and the
   16 kHz mixer's (32 windows of 1.5 s); K2
   on a spectrum with large imaginary DC and Nyquist parts, and K2's time
   a call at the bench shape for each number of frames a block may compute;
   K3 at the four upsamplings of a batch-16 training step, of a
   batch-256 bench batch, of the width-0.25 student's batch-16 mask
   step and of the s2d pyramid's batch-16 mask and crop steps, in bf16
   and fp32, forward and backward; K4
   (overlap-add, a standalone op that no path calls) at the bench shape, a
   ragged one at hop 100 and batch 10 at hop 512, in fp32 and bf16; the
   row LayerNorm (MP-SENet's conformer norms, no TPU kernel) at the
   10 s cell's shape (3,200 x 1,601 x 64) in bf16 against its plain
   version and ``F.layer_norm`` (one bf16 ulp beside float32's rounding),
   timed beside its byte bound; the conv module's GLU, depthwise conv,
   BatchNorm and SiLU kernel at the time conformer's 5,123,200 x 256 in
   bf16 against its plain version (one bf16 ulp beside float32's rounding),
   timed beside its byte bound, its plain version and PyTorch's six-pass
   sequence. Each
   library's variant counters say which entry ran: K1's and K2's FFT entries
   for n_fft 512, K3's TMA + wgmma variant at every U-Net layer in bf16;
   then the folded conv's two routes at the 18 ReLU'd conv shapes of a
   256-clip batch in bf16 (cuDNN's fused conv + bias + ReLU against
   conv(+bias) then ReLU): first-call and per-call ms, summed to a batch;
   the Mamba mixer's conv and selective scan (SEMamba's; no TPU kernel)
   at the 10 s cell's two shapes (3,200 x 1,601 and 51,232 x 100, d_inner
   256) in bf16, both directions, against their plain versions (one bf16
   ulp beside float32's rounding), each timed beside its byte bound and
   its plain route;
3. serve HTTP requests through the full-width 31,042,369-parameter
   BN-folded bf16 U-Net (``DenoiseService`` + ``make_http_server``) and
   check each answer against a direct ``DenoiserRunner`` call; K1 and K2's
   launch counters must rise during the requests (each through its FFT
   entry only), K4's must stay 0;
3b. the recommended deployment, the full-width 31,043,586-parameter
   residual ``ComplexMaskUNet``: seeded weights written with the port's
   ``export_model`` as ``mask_denoiser_mixed.ckpt`` + sidecar and read back
   bit-equal, served by ``cli.serve.build_server`` (``--model complex_mask
   --noise_type mixed``: ``load_model_for_noise(stem="mask_denoiser")``
   folded to bf16, warm-up, a WOLA streamer), 5 ``/denoise`` requests in
   ``complex_mask`` mode each against a direct runner call, one
   ``/stream`` session fed 3 s in ragged packets and flushed (as many
   samples out as in); K1 and K2 counted (FFT entries only), K4 0;
3c. streaming and serving of the same deployment (its export written
   again), every check fatal, cuDNN's fp32 in full fp32: ``cli.serve
   --stream_latency_ms 224`` (``latency_samples`` 1792, a 3 s stream in
   ragged packets as long out as in; the same low-latency session in fp32
   on the card against the CPU); ``--precision f32 --stream_pool 8``:
   8 concurrent HTTP sessions from threads with uneven packets, each
   against a dedicated session on the same runner, the pool's advances
   fewer than the sessions' hops and equal to K1's launches, a 9th start
   a 503 and a flushed slot reused, and the bf16 pool's gap to dedicated
   sessions printed; ``--stream_pool auto``'s capacity (at least 8) and
   probe bytes; a ``?rate=16000`` session, sample-exact and against the
   CPU's run of the same session; ``POST /admin/reload`` of a second
   export (generation 1 in the answer and ``/healthz``, the session
   opened before on the old model, a new session and ``/denoise`` on the
   new one, an unreadable checkpoint a 500 with generation 1 serving on);
   K1 and K2 through their FFT entries only and K4 at 0 after each; then
   the stream benches of ``eval.bench`` (8 and 16 kHz sessions, pools of
   8 and 64) on one JSON line beside the card's name and power limit;
3d. MP-SENet's serving path: ``DenoiserRunner`` in mode ``mag_pha`` over
   the bf16 ``MPSENet`` (seeded weights) on 32 clips of 10 s at 16 kHz,
   K1 and K2 one launch each through their direct entries (n_fft 400,
   hop 100), the 40 LayerNorms through the row LayerNorm kernel and the 8
   conv modules through the conv-module kernel, none through a plain
   version, counted from 0; then K1 and K2 each against its plain version on the
   runner's own inputs (unit-RMS clips padded by reflection, the model's
   answer in polar form), timed beside its bound at that shape;
3e. SEMamba's serving path: ``DenoiserRunner`` in mode ``mag_pha`` over
   the bf16 ``SEMamba`` (seeded weights) on 32 clips of 10 s at 16 kHz, K1
   and K2 one launch each through their direct entries, the 16 conv and
   16 scan launches through the ssm kernels, none plain, counted from 0;
   the batch's time and peak memory;
4. run the serving slice in fp32 on the card (kernels) and on the CPU
   (plain versions) for one 2 s clip and compare; the same for the mask
   slice, and a streamed fp32 mask session against the offline
   ``StreamingDenoiser.denoise`` of the same signal;
4c. evaluation: the plain iSTFT on the card ignores imaginary DC and
   Nyquist parts (n_fft 512 and 2048) and K2 agrees with it on the spectrum
   it was given; Griffin-Lim (50 iterations, 5 clips of 3 s, both modes)
   through K1 and K2 on the card against the plain versions on the CPU from
   one magnitude and initial phase, K1 launched 50 and K2 51 times a call
   through their FFT entries, and its time a call with the kernels and with
   ``torch.fft``; ``python -m audiodenoiser_torch.cli.create_test_dataset``
   on 8 synthetic 3 s wavs and 3 noise wavs; three ``cli.test`` runs over
   that set (the full-width U-Net's specialists in ``reference_gl`` and
   ``griffin_lim``, and the universal mask model over the four noise types
   and 2 seeds), their artifacts, metrics and each specialist's K1/K2
   launches; one ``/denoise`` request each in ``?mode=griffin_lim`` and
   ``?mode=reference_gl`` on ``cli.serve --mode griffin_lim``, each against
   a direct runner call on the batch the service formed;
5. one full-width fp32 training step (mixer with K1, U-Net with K3) on the
   card against the CPU from the same weights, chunks and noise draws (the
   two featurizations within one float16 rounding, then one batch for both);
6. ``train.loop.fit`` of the full-width bf16 ``UNet(pallas_deconv=True)``
   on the on-device mixer: 2 epochs of 10 steps at batch 16, K1 (FFT entry
   only) and K3 (TMA + wgmma only) counted (K4 0), K3's cached weight packs
   held to the weights the optimizer left and a K3 forward on them against
   the plain version, the export served, then 3 more train steps (the
   kernels' variants, a finite loss); and ``python -m
   audiodenoiser_torch.cli.train`` on wavs;
6c. complex-mask training: K2's gradient (its backward is K1) at the mask
   step's shape against autograd through the plain iSTFT, imaginary
   DC/Nyquist parts getting exactly 0; one full-width fp32 mask train step
   on the card against the CPU (the losses, the loss's gradient with
   respect to the mask, the CPU's gradients through the card's AdamW; the
   parameter gradients of each device against a float64 backward on the
   card, which at two levels the card's meet per tensor within 1e-4);
   ``fit`` of the full-width bf16 residual ``ComplexMaskUNet``
   (bound 8, K3) on the ``mixed`` mixer's waveforms, 2 epochs of 10 steps,
   K1 2 launches a train step and 1 a validation step, K2 1 a step, K3 4 a
   forward (FFT entries and TMA + wgmma only, K4 0), its ``.ckpt`` served by
   ``cli.serve --model complex_mask`` (2 requests against direct calls);
   ``cli.train --model complex_mask --noise_type mixed`` in a subprocess;
   3 bf16 mask train steps (K1 2, K2 1 and K3 4 launches a step, a finite
   loss);
6d. the training set and the training extras: the native loader built
   with g++ into ``_build/`` (``load_batch`` against the scipy path within
   1e-6, ``load_clean_chunks`` through it); ``cli.create_train_dataset`` in
   a subprocess over 132 synthetic 4 s wavs and 3 noise wavs (264 chunks:
   file count, (257, 122) float32 finite files, K1 2 x 4 x 2 launches
   through its FFT entry, chunks a second; the clean and reverb files within
   1e-5 of max|CPU| of a CPU build); ``cli.train --pipeline npy`` on that
   set with warm-up + cosine, ``--grad_accum 2``, ``--ema_decay 0.999``,
   ``--ckpt_every 1`` and ``--profile_dir`` (``.ckpt`` export, EMA export,
   trace), then ``--resume --epochs 2`` (epoch index 1 alone); beside it
   ``cli.train --sample_rate 16000 --chunk_seconds 1.5`` (its sidecar); the
   shipped ``.ckpt`` answering one clip through ``DenoiserRunner``, and
   ``.ckpt`` -> ``cli.export_checkpoint`` -> ``.pth`` ->
   ``cli.import_checkpoint`` -> the same bytes, ``--quantize`` an int8-v1
   export that answers too; at full width in fp32, cuDNN deterministic, an
   uninterrupted 2-epoch ``fit`` against 1 epoch and a resumed one (weights
   and EMA within 1e-6 relative L2, the conv biases that feed a train-mode
   BatchNorm printed apart), a remat step against a plain one
   (within 1e-6, ``num_batches_tracked`` moved once) and four
   ``--grad_accum 2`` micro-steps with cosine and an EMA card against CPU
   (1e-4); the bf16 mask family under the same extras for an epoch and a
   resumed one (K1, K2 and K3 counted exactly); then bf16 batch-16 steps
   with K3: peak memory and step time with and without remat, with an EMA
   and with ``--grad_accum 2``;
6e. the self-routing deployment at full width, over phase 4c's test set
   and phase 6d's wavs: four seeded 31,042,369-parameter magnitude and
   four 31,043,586-parameter residual mask specialists written with
   ``export_model``; ``cli.train --model router --pipeline on_device
   --noise_type mixed`` in a subprocess (300 steps of 64; the export, its
   window sidecar, 98,148 parameters, held-out accuracy above 0.5);
   ``cli.serve --auto_route``: 8 ``/denoise?mode=auto`` requests corrupted
   the four ways, seven coalesced behind the first, each against its
   predicted expert's runner on the padded group the service formed, K1
   launched once a classify call and once a group, K2 once a group (FFT
   entries only, K4 0), a ``?mode=auto`` stream of 6 s against a direct
   ``RoutedStreamingSession``, ``/admin/reload`` to generation 1 answering
   the next request; in fp32, card against CPU, the router's logits on 8
   clips, a routed ``denoise_waveform`` and a stream re-routed every 1 s
   chunk whose corruption turns from white noise to reverb (the same
   switches); ``cli.test --auto_route`` for both families (routed metrics
   files, finite, routing accuracy printed); the router's forward at 256
   windows and a routed batch of 256 mixed-corruption 2 s clips against
   one expert on the whole batch, on one JSON line with the card;
6f. the compact distilled student, width 0.25, over phase 6d's wavs: a
   seeded full-width residual mask teacher (bound 8) exported with its
   sidecar; ``cli.train --model complex_mask --noise_type mixed
   --width_mult 0.25 --distill_from <teacher> --distill_features 1.0
   --export_quantized`` in a subprocess (an int8-v1 export of 1,944,066
   parameters, JAX's sidecar keys); one fp32 distilled step on the card
   against the CPU from the same trees and draws (losses and weights
   within 1e-4, K1 2, K2 1, K3 4 launches); ``fit`` of the bf16 student
   with K3 against the bf16 live-BN teacher, K1, K2 and K3 counted exactly
   (K3 through wgmma only), then its ms a step and peak memory with and
   without the teacher; the int8 export served by ``cli.serve --model
   complex_mask --noise_type mixed`` (5 ``/denoise`` answers against direct
   calls, a 3 s stream as long out as in); the student's serving benches
   at batch 256 (folded in both modes, live-BN with K3) and the training
   leg of ``eval.bench`` at batch 256 and 16, each with its device idle
   share;
6g. the rest of the model menu, over phase 6d's wavs: in fp32 at the
   whole-clip shape (257, 126), 2 clips, cuDNN's TF32 off, the seeded
   full-width 31,048,641-parameter ``UNet(s2d_stem, s2d_skip=16)`` and the
   32,106,242-parameter residual ``ComplexMaskUNet`` (bound 8) with all
   three switches (a nonzero attention projection), live-BN and folded,
   card against CPU within 1e-4; the full-width ``Int8UNet`` card against
   CPU on one input (the first conv's int32 accumulator bit-equal, the
   input's rounding flips counted, the forward's relative L2 and its gap to
   the fp32 folded forward printed, the forward within 1e-5 and every
   layer bit-equal on the CPU's own inputs); ``cli.train --model
   complex_mask --s2d_stem --s2d_skip 16 --attn_bottleneck`` in bf16 in
   a subprocess (its ``[launches]`` line: K1 2 a train step and 1 a
   validation step, K2 1 a step, K3 and K4 0 as in JAX's CLI; the export
   and JAX's sidecar keys); ``fit`` of the same bf16 model with
   ``pallas_deconv`` on the mixed mixer (K1 and K2 as above, K3 4 a
   forward through wgmma alone, K4 0); the export served by ``cli.serve``
   (5 ``/denoise`` answers against direct calls, a 3 s stream as long out
   as in); the variant legs of ``eval.bench`` at batch 256 with their
   device breakdowns: s2d and s2d_skip 16 folded in noisy-phase mode, int8
   with its peak memory, the three switches folded in complex-mask mode,
   and the s2d training leg;
6h. the ('data', 'model') mesh on the one card (world size 1, NCCL),
   over phase 6d's wavs: ``cli.train`` of the magnitude U-Net with
   ``--mesh off``, ``--mesh on`` and ``--mesh on --fsdp`` (4 bf16 steps
   and 1 validation at batch 16: the mesh in the log, K1 5 launches
   through its FFT entry, K3 and K4 0, finite losses), and ``--mesh on
   --model_parallel 2``, which must stop with JAX's "not divisible by
   model_parallel=2" and a nonzero exit; one full-width fp32 step through
   ``fit`` with ``use_mesh=True`` against the unmeshed step, both families,
   cuDNN deterministic (every tensor within 1e-6 relative L2, the conv
   biases that feed a train-mode BatchNorm printed apart); a meshed
   bf16 ``fit`` of ``UNet(pallas_deconv=True)`` (K3 4 a forward, wgmma
   only); two ranks sharing the card over gloo (dp 2: one fp32 step's loss
   and global norm within 1e-5 of one rank's, the same on both ranks); the
   folded bf16 runner at 256 clips of 2 s on the mesh against the unmeshed
   runner (within 1e-6; K1 and K2 once a call) and both runners' frames/s;
   bf16 steps at batch 16 unmeshed, meshed and with fsdp, timed in turns
   (ms a step, peak memory);
6i. the rest of parallelism on the one card, over phase 6d's wavs:
   ``cli.train --pp_stages 1 --pp_microbatches 4`` (2 bf16 steps and 1
   validation at batch 16: the pipeline in the log, K1 3 launches, K3 and
   K4 0, its export served) and ``--pp_stages 2``, which must stop with
   JAX's "does not divide 1 devices"; ``PipelinedDenoiser`` at 2 and 4
   stages on ``cuda:0`` in fp32 against the monolithic U-Net (1e-5), then
   bf16 at 256 x 2 s magnitudes at 1, 2 and 4 stages beside the monolithic
   forward (frames/s, peak memory); gloo probes on CUDA tensors in
   processes of their own (a point-to-point swap between two ranks, an
   ``all_to_all_single`` over four); four ranks sharing the card over
   gloo, each with one full-width expert: ``denoise_ep`` and
   ``denoise_ep_a2a`` (capacity factors 1.0 and 4.0) on 64 clips of 2 s in
   fp32 against the bucketed dispatch (1e-6; ``n_passes`` by JAX's rule),
   and, where the point-to-point probe passes, a two-rank sharded clip;
   a 60 s clip through ``denoise_waveform_sharded`` on a world-size-1
   ('seq',) mesh (NCCL) against the padded oracle (1e-5; K1 and K2 once)
   and timed beside the runner; the 1F1B trainer at 2 and 4 stages, one
   full-width fp32 step against ``fit``'s step with ``grad_accum`` 4
   (losses 1e-5, tensors 1e-4, the BN-fed conv biases 4 x lr), then bf16
   steps at batch 16 beside the monolithic step;
7. measure throughput with ``eval.bench.run_bench`` at batch 256, folded,
   with ``pallas_deconv`` (K1, K2 and K3 counted; K1 and K2 through their
   FFT entries and K3 through TMA + wgmma only) and in ``complex_mask`` mode
   (K1 and K2 counted, through their FFT entries only), the student's
   frames/s beside each headline, the model menu's and the meshed runner's
   beside the noisy-phase one.

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
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
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
# ... and of the width-0.25 student's mask step (batch 16 of 2 s clips, 257 x 126)
DECONV_STUDENT = ((16, 256, 16, 7, 128), (16, 128, 32, 15, 64),
                  (16, 64, 64, 31, 32), (16, 32, 128, 63, 16))
# ... and of the s2d pyramid at batch 16: the mask step's (129 x 63 after the
# stem) and the crop step's (128 x 32 after it, M down to 16 x 8 x 2 = 256)
DECONV_S2D_MASK = ((16, 1024, 8, 3, 512), (16, 512, 16, 7, 256),
                   (16, 256, 32, 15, 128), (16, 128, 64, 31, 64))
DECONV_S2D_CROP = ((16, 1024, 8, 2, 512), (16, 512, 16, 4, 256),
                   (16, 256, 32, 8, 128), (16, 128, 64, 16, 64))
DECONV_SETS = (("train", DECONV_TRAIN), ("bench", DECONV_BENCH),
               ("student", DECONV_STUDENT), ("s2d_mask", DECONV_S2D_MASK),
               ("s2d_crop", DECONV_S2D_CROP))
TRAIN_TOL = 1e-4  # fp32 training step, card vs CPU: loss, grad norm, BN stats


def ptxas_summary(log: str) -> list:
    """Per kernel entry of one library (by its mangled name), what ``nvcc
    -Xptxas -v`` reported: registers, static shared memory and spill bytes."""
    entries = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entries.append({"entry": m.group(1)})
        elif entries and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill", line)
            entries[-1].update(spill_stores=int(st), spill_loads=int(ld))
        elif entries and "Used" in line and "registers" in line:
            entries[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entries[-1]["static_smem"] = int(smem.group(1)) if smem else 0
    return entries


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


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn``: its kernels' own time, summed by
    the profiler over ``reps`` calls after a warm-up. Events around a short
    call measure the host's launch cost instead (tens of microseconds for
    one wrapper call). A profile that sees no device time at all, which the
    card's profiler now and then returns for a short window, is taken
    again, up to three times in all."""
    import torch

    from audiodenoiser_torch.eval.bench import device_breakdown

    for _ in range(3):
        fn()
    for attempt in range(3):
        busy = device_breakdown(fn, reps, torch.device("cuda"))["device_busy_ms"]
        if isinstance(busy, float):
            break
        print(f"[profile] no device time in profile {attempt + 1} of 3", flush=True)
    check(isinstance(busy, float), "the profiler saw no device time")
    return busy


def timings(kernel, plain, library, plain_reps: int = 20) -> dict:
    """The kernels line's times of one call each of the kernel, its plain
    version and the library call: ``ms``, ``plain_ms``, ``library_ms`` by
    CUDA events per call, host launch cost included (the measure of every
    earlier run), and beside them the device time of each from the profiler
    as ``device_ms``, ``plain_device_ms``, ``library_device_ms``."""
    out = {}
    for prefix, fn, reps in (("", kernel, 20), ("plain_", plain, plain_reps),
                             ("library_", library, 20)):
        out[f"{prefix}ms"] = time_ms(fn, reps)
        out[f"{prefix}device_ms"] = device_ms(fn, min(reps, 10))
    return out


def show(times: dict) -> str:
    return " ".join(f"{k}={v:.4f}" for k, v in times.items())


def require_variants(run: str, expect: dict) -> dict:
    """After a main path's run, read each named kernel's variant counters:
    the expected variant must have carried every launch (at least one), the
    others none. Returns the counters by kernel."""
    from audiodenoiser_torch.ops import cuda as kc

    seen = {}
    for name, variant in expect.items():
        kernel = getattr(kc, name)
        counts = kc.variant_launches(kernel)
        print(f"[launches] {name}: {kernel.launches} during {run}, by variant {counts}",
              flush=True)
        check(kernel.launches > 0 and counts[variant] == kernel.launches,
              f"{name} did not run through its {variant} variant alone during {run}")
        seen[name] = counts
    return seen


def stft_bound_ms(batch: int, n_frames: int, signal_len: int,
                  n_fft: int = N_FFT) -> tuple[float, str]:
    """Least time for one STFT or iSTFT at these shapes, whatever the
    algorithm: the larger of its bytes (signal + re/im planes + window,
    each moved once) over the memory rate and the operations of an FFT
    (2.5*n_fft*log2(n_fft) per real frame, plus the window multiply) over
    the fp32 non-tensor rate."""
    n_freq = n_fft // 2 + 1
    nbytes = 4 * batch * (signal_len + 2 * n_freq * n_frames) + 4 * n_fft
    flops = batch * n_frames * (2.5 * n_fft * math.log2(n_fft) + n_fft)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def direct_dft_ms(batch: int, n_frames: int, n_fft: int = N_FFT) -> float:
    """The floor of the kernels' own algorithm, a direct DFT (re and im,
    one FMA each per sample and bin): a reference, not the bound."""
    flops = 4 * n_fft * (n_fft // 2 + 1) * n_frames * batch
    return flops / PEAK_FP32_FLOPS * 1e3


def phase_kernels(torch, rng):
    """Phase 2: each kernel against its plain version; returns the bench-
    shape rows of the kernels line (launches filled in by phase 3)."""
    import torch.nn.functional as F

    from audiodenoiser_torch.dsp.stft import overlap_add
    from audiodenoiser_torch.dsp.window import hann_window
    from audiodenoiser_torch.ops.cuda import (
        istft_kernel,
        istft_plain,
        stft_kernel,
        stft_plain,
        variant_launches,
    )
    from audiodenoiser_torch.ops.cuda.istft import frames_per_block_log2

    dev = torch.device("cuda")
    w = torch.from_numpy(hann_window(N_FFT)).to(dev)
    rows = {}
    # (label, batch, samples, centred): the uncentred ones are the training
    # set's device batch (256 chunks of 2 s) and the mixer's at 16 kHz with
    # 1.5 s windows (noisy and clean of a batch of 16 in one launch)
    for label, batch, n, centred in (("bench", 256, 16000, True), ("ragged", 3, 24800, True),
                                     ("stream", 1, 16000, True), ("pool8", 8, 16000, True),
                                     ("pool64", 64, 16000, True),
                                     ("trainset", 256, 16000, False),
                                     ("mixer16k", 32, 24000, False)):
        audio = torch.from_numpy(
            (0.2 * rng.standard_normal((batch, n))).astype("float32")).to(dev)
        pad = N_FFT // 2 if centred else 0
        x = F.pad(audio, (pad, pad)).contiguous()
        n_frames = 1 + (x.shape[1] - N_FFT) // HOP

        fft_before = stft_kernel.fft_launches
        spec_k = stft_kernel(x, w, N_FFT, HOP)
        spec_p = stft_plain(x, w, N_FFT, HOP)
        torch.cuda.synchronize()
        check(stft_kernel.fft_launches == fft_before + 1, f"K1 at {label} took another entry")
        check(spec_k.shape == spec_p.shape == (batch, N_FFT // 2 + 1, n_frames),
              f"K1 shape {tuple(spec_k.shape)} at {label}")
        ref = torch.view_as_real(spec_p)
        err1 = (torch.view_as_real(spec_k) - ref).abs().max().item()
        scale1 = ref.abs().max().item()

        parts = torch.view_as_real(spec_p)
        re, im = parts[..., 0], parts[..., 1]
        fft_before = istft_kernel.fft_launches
        y_k = istft_kernel(re, im, w, N_FFT, HOP)
        y_p = istft_plain(re, im, w, N_FFT, HOP)
        torch.cuda.synchronize()
        check(istft_kernel.fft_launches == fft_before + 1, f"K2 at {label} took another entry")
        check(y_k.shape == y_p.shape == (batch, (n_frames - 1) * HOP + N_FFT),
              f"K2 shape {tuple(y_k.shape)} at {label}")
        err2 = (y_k - y_p).abs().max().item()
        scale2 = y_p.abs().max().item()
        print(f"[kernels] {label} B={batch} L={x.shape[1]} T={n_frames}: "
              f"K1 max_abs_err={err1:.3e} max_rel_err={err1 / scale1:.3e}; "
              f"K2 max_abs_err={err2:.3e} max_rel_err={err2 / scale2:.3e} "
              f"({1 << frames_per_block_log2(batch, n_frames, N_FFT, HOP)} frames a block)",
              flush=True)
        # K1 and K2 hold the tighter bound of tests/test_torch_cuda.py
        check(err1 <= 1e-5 * scale1, f"K1 disagrees with plain at {label}")
        check(err2 <= 1e-5 * scale2, f"K2 disagrees with plain at {label}")
        if label == "ragged":
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
        calls = {
            "stft_kernel": (
                lambda: stft_kernel(x, w, N_FFT, HOP),
                lambda: stft_plain(x, w, N_FFT, HOP),
                lambda: torch.stft(x, N_FFT, HOP, window=w, center=False, return_complex=True),
                err1),
            "istft_kernel": (
                lambda: istft_kernel(re, im, w, N_FFT, HOP),
                lambda: istft_plain(re, im, w, N_FFT, HOP),
                library_istft,
                err2),
        }
        bound, bound_by = stft_bound_ms(batch, n_frames, x.shape[1])
        dft_ms = direct_dft_ms(batch, n_frames)
        replaces = {"stft_kernel": "audiodenoiser_tpu/ops/pallas/stft_kernel.py:117",
                    "istft_kernel": "audiodenoiser_tpu/ops/pallas/istft_kernel.py:138"}
        for name, (kernel, plain, library, err) in calls.items():
            times = timings(kernel, plain, library)
            print(f"[kernels] {name} {label}: {show(times)} bound_ms={bound:.4f} "
                  f"({bound_by}) direct_dft_ms={dft_ms:.4f}", flush=True)
            if label != "bench":  # the bench shape comes first
                rows[name].setdefault("other_shapes", {})[label] = {
                    **times, "bound_ms": bound, "bound_by": bound_by}
                continue
            rows[name] = {
                "name": name, "route": "cuda",
                "source": f"audiodenoiser_torch/csrc/{name}.cu",
                "replaces": replaces[name], "max_abs_err": err,
                "bound_ms": bound, "bound_by": bound_by, **times,
            }
    istft_edges(torch, rng, w)
    istft_frames_sweep(torch, rng, w)
    print(f"[kernels] K1 entries used in phase 2: {variant_launches(stft_kernel)}; "
          f"K2's: {variant_launches(istft_kernel)}", flush=True)
    check(stft_kernel.direct_launches == 0, "K1 took its direct entry at n_fft 512")
    check(istft_kernel.direct_launches == 0, "K2 took its direct entry at n_fft 512")
    return rows


def istft_edges(torch, rng, w):
    """K2 at the bench shape on a spectrum whose DC and Nyquist bins carry
    large imaginary parts: irfft and B2's bases ignore them, so must K2."""
    from audiodenoiser_torch.ops.cuda import istft_kernel, istft_plain

    shape = (256, N_FFT // 2 + 1, 126)
    spec = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    spec[:, [0, -1]] = spec[:, [0, -1]].real
    edges = spec.copy()
    edges[:, [0, -1]] += 50j * rng.standard_normal((256, 2, 126))
    # the plain version sees them zero: cuFFT's C2R takes its input as
    # Hermitian and need not ignore them
    re, im = torch.view_as_real(torch.from_numpy(spec.astype("complex64")).cuda()).unbind(-1)
    re_e, im_e = torch.view_as_real(torch.from_numpy(edges.astype("complex64")).cuda()).unbind(-1)
    fft_before = istft_kernel.fft_launches
    y_k = istft_kernel(re_e, im_e, w, N_FFT, HOP)
    y_p = istft_plain(re, im, w, N_FFT, HOP)
    torch.cuda.synchronize()
    err = (y_k - y_p).abs().max().item()
    scale = y_p.abs().max().item()
    print(f"[kernels] K2 with imaginary DC and Nyquist parts: max_abs_err={err:.3e} "
          f"max_rel_err={err / scale:.3e}", flush=True)
    check(istft_kernel.fft_launches == fft_before + 1, "K2 (edges) took another entry")
    check(err <= 1e-5 * scale, "K2 used the imaginary parts of DC or Nyquist")


def istft_frames_sweep(torch, rng, w):
    """Time of K2's FFT entry at the bench shape for each number of frames a
    block may compute (more than the 3 halo frames), through the launch
    helper, which counts nothing; the wrapper's pick is marked. CUDA events
    per call: the host issues these calls faster than the card runs them."""
    from audiodenoiser_torch.ops.cuda import istft
    from audiodenoiser_torch.ops.cuda.istft import frames_per_block_log2

    shape = (256, N_FFT // 2 + 1, 126)
    spec = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    parts = torch.view_as_real(torch.from_numpy(spec.astype("complex64")).cuda())
    re, im = parts[..., 0], parts[..., 1]
    out = torch.empty((256, 125 * HOP + N_FFT), device="cuda")
    pick = frames_per_block_log2(256, 126, N_FFT, HOP)
    times = {}
    for log_tt in range(2, 5):
        ms = time_ms(lambda: istft.fft_launch(re, im, w, out, N_FFT, HOP, log_tt), reps=50)
        times[f"{1 << log_tt}{'*' if log_tt == pick else ''}"] = round(ms, 4)
    print(f"[kernels] istft_kernel bench, ms a call by frames a block: {times}", flush=True)


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
        seen = require_variants("the noisy-phase requests",
                                {"stft_kernel": "fft", "istft_kernel": "fft"})
        for name in seen:
            rows[name]["variant_launches"] = seen[name]
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


MP_LAYER_NORMS = 40  # 4 TS-Conformers x 2 conformers x (ffm1, attn, ccm, ffm2, post_ln)
MP_CONV_MODULES = 8  # 4 TS-Conformers x 2 conformers


def phase_mpsenet(torch, rng, rows):
    """Phase 3d: MP-SENet's serving path, ``DenoiserRunner`` mode
    ``mag_pha`` over the bf16 model, on 32 clips of 10 s at 16 kHz (the
    ``mpsenet2m.dns10s`` batch): K1 and K2 take their direct entries at
    n_fft 400 / hop 100, one launch each, from launch counts set to 0
    just before, and the 40 LayerNorms take the hand-written kernel, none
    its plain version, and the 8 conv modules take theirs. Then K1 and K2
    are each held to their plain version
    on the runner's own inputs (the unit-RMS clips padded by reflection;
    the model's answer in polar form) and timed beside their bound at that
    shape."""
    import numpy as np
    import torch.nn.functional as F

    from audiodenoiser_torch.dsp.window import hann_window
    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.models.mpsenet import MPSENet, mag_pha
    from audiodenoiser_torch.ops.cuda import (
        istft_kernel,
        istft_plain,
        reset_launch_counts,
        stft_kernel,
        stft_plain,
    )

    dev, batch, seconds, sr = torch.device("cuda"), 32, 10, 16000
    torch.manual_seed(19)
    model = MPSENet().to(dev, torch.bfloat16).eval()
    n_fft, hop = model.n_fft, model.hop_length
    audio = torch.from_numpy(np.clip(0.2 * rng.standard_normal((batch, seconds * sr)), -1, 1)
                             .astype(np.float32)).to(dev)
    runner = DenoiserRunner(model, device=dev)
    runner.denoise_audio(audio[:2])  # cuDNN's first plans, outside the counts
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = runner.denoise_audio(audio)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    seen = require_variants("the MP-SENet runner", {"stft_kernel": "direct",
                                                    "istft_kernel": "direct",
                                                    "layer_norm_kernel": "kernel",
                                                    "conv_module_kernel": "kernel"})
    check(stft_kernel.launches == istft_kernel.launches == 1,
          "the MP-SENet batch took more than one K1 and one K2 launch")
    check(seen["layer_norm_kernel"] == {"kernel": MP_LAYER_NORMS, "plain": 0},
          f"the MP-SENet batch's LayerNorms by route {seen['layer_norm_kernel']}")
    check(seen["conv_module_kernel"] == {"kernel": MP_CONV_MODULES, "plain": 0},
          f"the MP-SENet batch's conv modules by route {seen['conv_module_kernel']}")
    rows["layer_norm_kernel"]["launches"] = MP_LAYER_NORMS
    rows["conv_module_kernel"]["launches"] = MP_CONV_MODULES
    count_off_path(rows, "the MP-SENet runner")
    check(out.shape == audio.shape and bool(torch.isfinite(out).all()),
          "the MP-SENet runner's answer is not finite at the clips' shape")

    w = torch.from_numpy(hann_window(n_fft)).to(dev)
    scaled = audio * torch.rsqrt(audio.square().mean(-1, keepdim=True))
    x = F.pad(scaled[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0].contiguous()
    n_frames = 1 + (x.shape[1] - n_fft) // hop
    spec_k = stft_kernel(x, w, n_fft, hop)
    spec_p = stft_plain(x, w, n_fft, hop)
    with torch.no_grad():
        mag_c, pha = model(*mag_pha(spec_p, n_fft, model.win_length))
    rec = torch.polar(mag_c.pow(1.0 / model.compress_factor), pha)
    re, im = rec.real.contiguous(), rec.imag.contiguous()
    y_k = istft_kernel(re, im, w, n_fft, hop)
    y_p = istft_plain(re, im, w, n_fft, hop)
    torch.cuda.synchronize()
    check(spec_k.shape == spec_p.shape == (batch, n_fft // 2 + 1, n_frames),
          f"K1 shape {tuple(spec_k.shape)} at the MP-SENet batch")
    check(y_k.shape == y_p.shape == (batch, (n_frames - 1) * hop + n_fft),
          f"K2 shape {tuple(y_k.shape)} at the MP-SENet batch")
    ref1 = torch.view_as_real(spec_p)
    err1 = (torch.view_as_real(spec_k) - ref1).abs().max().item()
    scale1 = ref1.abs().max().item()
    err2 = (y_k - y_p).abs().max().item()
    scale2 = y_p.abs().max().item()
    print(f"[mpsenet] B={batch} L={x.shape[1]} T={n_frames} n_fft={n_fft} hop={hop}: "
          f"runner {run_s:.3f} s, launches by entry K1 {seen['stft_kernel']} "
          f"K2 {seen['istft_kernel']}; K1 max_rel_err={err1 / scale1:.3e}, "
          f"K2 max_rel_err={err2 / scale2:.3e}", flush=True)
    check(err1 <= 1e-5 * scale1, "K1's direct entry disagrees with plain at n_fft 400")
    check(err2 <= 1e-5 * scale2, "K2's direct entry disagrees with plain at n_fft 400")

    def library_istft():
        frames = torch.fft.irfft(torch.complex(re, im).transpose(-1, -2), n=n_fft, dim=-1) * w
        return F.fold(frames.transpose(1, 2), (1, y_p.shape[1]), (1, n_fft), stride=(1, hop))

    calls = {
        "stft_kernel": (stft_kernel, lambda: stft_kernel(x, w, n_fft, hop),
                        lambda: stft_plain(x, w, n_fft, hop),
                        lambda: torch.stft(x, n_fft, hop, window=w, center=False,
                                           return_complex=True), err1),
        "istft_kernel": (istft_kernel, lambda: istft_kernel(re, im, w, n_fft, hop),
                         lambda: istft_plain(re, im, w, n_fft, hop), library_istft, err2),
    }
    bound, bound_by = stft_bound_ms(batch, n_frames, x.shape[1], n_fft)
    dft_ms = direct_dft_ms(batch, n_frames, n_fft)
    for name, (entry, kernel, plain, library, err) in calls.items():
        times = timings(kernel, plain, library)
        check(entry.fft_launches == 0, f"{name} took its FFT entry at n_fft 400")
        print(f"[kernels] {name} mpsenet: {show(times)} bound_ms={bound:.4f} "
              f"({bound_by}) direct_dft_ms={dft_ms:.4f}", flush=True)
        rows.setdefault(name, {}).setdefault("other_shapes", {})["mpsenet"] = {
            **times, "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
            "runner_launches": seen[name]}
    reset_launch_counts()


SM_MIXERS = 16  # 4 TF-Mamba blocks x 2 halves x 2 directions
# a mixer's tokens in the SEMamba cell: the time axis's 32 x 100 bins of
# 1,601 frames, the frequency axis's 32 x 1,601 frames of 100 bins
SSM_SHAPES = {"time": (3200, 1601), "freq": (51232, 100)}
SSM_INNER = 256


def phase_ssm(torch, rng):
    """Phase 2, the Mamba mixer's conv and scan (SEMamba's; no TPU kernel):
    both entries against their plain versions at the cell's two shapes in
    bf16, both directions (within one bf16 ulp beside float32's rounding,
    ``bf16_gap``), each timed beside its byte bound and its plain route (the
    scan's plain route steps through the sequence one token at a time with
    PyTorch's operations). The bounds: the conv reads x and writes u (2 x
    256 bf16 a token), the scan reads u, z and x_dbl and writes y (3 x 256
    + 36 bf16 a token); the mixer's, x and z in and y out (3 x 256 bf16),
    is the one the benchmark's ``ssm_roofline`` reads."""
    import torch.nn.functional as F

    from audiodenoiser_torch.ops.cuda import ssm_conv, ssm_conv_plain, ssm_scan, ssm_scan_plain

    dev, d, row = torch.device("cuda"), SSM_INNER, None
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))

    def rand(*shape, scale=1.0, shift=0.0):
        return shift + scale * torch.randn(shape, generator=gen, device=dev)

    dt = torch.exp(torch.rand(d, generator=gen, device=dev) * math.log(100.0) + math.log(1e-3))
    states = torch.arange(1, 17, device=dev, dtype=torch.float32)
    scan = tuple(t.to(torch.bfloat16) for t in (
        (torch.rand((d, 4), generator=gen, device=dev) * 2 - 1) * 0.5,
        dt + torch.log(-torch.expm1(-dt)), torch.log(states) + rand(d, 16, scale=0.1),
        rand(d, scale=0.1, shift=1.0)))
    conv = tuple(t.to(torch.bfloat16) for t in (rand(d, 1, 4, scale=math.sqrt(0.5)),
                                                rand(d, scale=0.1)))
    x_proj = rand(36, d, scale=math.sqrt(2 / d)).to(torch.bfloat16)
    for label, (n, length) in SSM_SHAPES.items():
        xz = rand(n, length, 2 * d).to(torch.bfloat16)
        tokens = n * length
        bounds = {"conv": tokens * 2 * d * 2 / PEAK_BYTES_PER_S * 1e3,
                  "scan": tokens * (3 * d + 36) * 2 / PEAK_BYTES_PER_S * 1e3,
                  "mixer": tokens * 3 * d * 2 / PEAK_BYTES_PER_S * 1e3}
        for reverse in (False, True):
            with torch.inference_mode():
                u = ssm_conv(xz, *conv, reverse)
                x_dbl = F.linear(u, x_proj)
                y = ssm_scan(u, xz, x_dbl, *scan, reverse)
                torch.cuda.synchronize()
                (u_ulps, u_gap) = bf16_gap(u, ssm_conv_plain(xz, *conv, reverse))
                t0 = time.perf_counter()
                want = ssm_scan_plain(u, xz, x_dbl, *scan, reverse)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                (y_ulps, y_gap) = bf16_gap(y, want)
                del want
                times = {
                    "conv_ms": time_ms(lambda: ssm_conv(xz, *conv, reverse), 10, 2),
                    "conv_device_ms": device_ms(lambda: ssm_conv(xz, *conv, reverse), 5),
                    "conv_plain_ms": time_ms(lambda: ssm_conv_plain(xz, *conv, reverse), 3, 1),
                    "scan_ms": time_ms(lambda: ssm_scan(u, xz, x_dbl, *scan, reverse), 5, 1),
                    "scan_device_ms": device_ms(
                        lambda: ssm_scan(u, xz, x_dbl, *scan, reverse), 3),
                    "scan_plain_ms": 1e3 * plain_s}
            share = bounds["mixer"] / (times["conv_device_ms"] + times["scan_device_ms"])
            print(f"[kernels] ssm_kernel {label} {n} x {length} x {d} bf16 reverse={reverse}: "
                  f"{show(times)} conv_bound_ms={bounds['conv']:.4f} "
                  f"scan_bound_ms={bounds['scan']:.4f} mixer_bound_ms={bounds['mixer']:.4f} "
                  f"(bytes) mixer_share_of_bound={share:.3f}; bf16 ulps (beside float32 "
                  f"rounding) conv {u_ulps:.0f} ({u_gap:.3f}), scan {y_ulps:.0f} ({y_gap:.3f})",
                  flush=True)
            check(u_gap <= 1.0 and y_gap <= 1.0,
                  f"ssm_kernel is {u_gap}/{y_gap} bf16 ulps from its plain versions at the "
                  f"{label} shape, reverse={reverse}")
            figures = {"conv_bf16_gap": u_gap, "scan_bf16_gap": y_gap, "bound_by": "bytes",
                       **{f"{k}_bound_ms": v for k, v in bounds.items()}, **times,
                       "mixer_share_of_bound": share}
            del u, x_dbl, y
            key = f"{label}_reverse" if reverse else label
            if row is not None:
                row.setdefault("other_shapes", {})[key] = figures
                continue
            row = {"name": "ssm_kernel", "route": "cuda",
                   "source": "audiodenoiser_torch/csrc/ssm_kernel.cu",
                   "replaces": "none (SEMamba's Mamba mixers; the model exists only in the "
                               "port)", **figures}
        del xz
        torch.cuda.empty_cache()
    return row


def phase_semamba(torch, rng, rows):
    """Phase 3e: SEMamba's serving path, ``DenoiserRunner`` mode
    ``mag_pha`` over the bf16 model, on 32 clips of 10 s at 16 kHz (the
    ``semamba2m.dns10s`` batch): K1 and K2 one direct launch each, the 16
    conv and 16 scan launches through the ssm kernels and none plain, from
    launch counts set to 0 just before; the batch's time by CUDA events
    and its peak memory."""
    import numpy as np

    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.models.semamba import SEMamba
    from audiodenoiser_torch.ops.cuda import istft_kernel, reset_launch_counts, stft_kernel

    dev, batch, seconds, sr = torch.device("cuda"), 32, 10, 16000
    torch.manual_seed(23)
    model = SEMamba().to(dev, torch.bfloat16).eval()
    audio = torch.from_numpy(np.clip(0.2 * rng.standard_normal((batch, seconds * sr)), -1, 1)
                             .astype(np.float32)).to(dev)
    runner = DenoiserRunner(model, device=dev)
    runner.denoise_audio(audio[:2])  # cuDNN's first plans, outside the counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = runner.denoise_audio(audio)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    seen = require_variants("the SEMamba runner", {"stft_kernel": "direct",
                                                   "istft_kernel": "direct",
                                                   "ssm_kernel": "kernel"})
    check(stft_kernel.launches == istft_kernel.launches == 1,
          "the SEMamba batch took more than one K1 and one K2 launch")
    check(seen["ssm_kernel"] == {"kernel": 2 * SM_MIXERS, "plain": 0},
          f"the SEMamba batch's conv and scan by route {seen['ssm_kernel']}")
    rows["ssm_kernel"]["launches"] = 2 * SM_MIXERS
    count_off_path(rows, "the SEMamba runner")
    check(out.shape == audio.shape and bool(torch.isfinite(out).all()),
          "the SEMamba runner's answer is not finite at the clips' shape")
    ms = time_ms(lambda: runner.denoise_audio(audio), 3, 1)
    rate = batch * seconds / ms * 1e3
    print(f"[semamba] B={batch} x {seconds} s: {ms:.2f} ms a batch ({rate:.1f} "
          f"audio-s/s), peak {peak / 2 ** 30:.2f} GiB, launches K1 {seen['stft_kernel']} "
          f"K2 {seen['istft_kernel']} ssm {seen['ssm_kernel']}", flush=True)
    reset_launch_counts()


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
        require_variants("the mask deployment's requests and stream",
                         {"stft_kernel": "fft", "istft_kernel": "fft"})
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


STREAM_TOL = 1e-4  # relative L2, fp32: card vs CPU, pooled vs dedicated, old/new model


def _rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _signal(rng, n):
    import numpy as np

    return np.clip(0.2 * rng.standard_normal(n), -1, 1).astype(np.float32)


def _start(url: str, query: str = "") -> dict:
    req = urllib.request.Request(f"{url}/stream/start{query}", data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _feed(url: str, sid: str, signal, packets, flush: bool = True):
    """POST ``signal`` to a session in ``packets`` (sizes), then flush."""
    import numpy as np

    outs, start = [], 0
    for n in list(packets) + (["flush"] if flush else []):
        tail = "/flush" if n == "flush" else ""
        body = b"" if n == "flush" else signal[start:start + n].astype("<f4").tobytes()
        start += 0 if n == "flush" else n
        req = urllib.request.Request(f"{url}/stream/{sid}{tail}", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            outs.append(np.frombuffer(r.read(), "<f4"))
    return np.concatenate(outs)


def _session_out(sess, signal, packets):
    """A session object fed ``signal`` in ``packets`` and flushed."""
    import numpy as np

    outs, start = [], 0
    for n in packets:
        outs.append(sess.process(signal[start:start + n]))
        start += n
    return np.concatenate(outs + [sess.flush()])


def _ragged(n: int, seed: int) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(min(n - sum(sizes), rng.integers(300, 7000))))
    return sizes


def _serve(argv):
    from audiodenoiser_torch.cli.serve import build_server, parse_args

    service, server, _ = build_server(parse_args(argv))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return service, server, f"http://127.0.0.1:{server.server_address[1]}"


def _http_code(url: str, path: str) -> tuple[int, str]:
    req = urllib.request.Request(f"{url}{path}", data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _write_mask_export(d: str, variables) -> None:
    from audiodenoiser_torch.train.checkpoints import export_model

    export_model(os.path.join(d, "mask_denoiser_mixed.ckpt"), variables["params"],
                 variables["batch_stats"])
    with open(os.path.join(d, "mask_denoiser_mixed.json"), "w") as f:
        json.dump({"width_mult": 1.0, "mask_bound": 2.0, "residual": True}, f)


def _cpu_runner(d: str):
    import torch

    from audiodenoiser_torch.eval.runner import DenoiserRunner, load_model_for_noise

    return DenoiserRunner(load_model_for_noise("mixed", d, dtype=torch.float32, device="cpu",
                                               stem="mask_denoiser"), device="cpu")


def _stream_kernels(rows, run: str) -> None:
    """K1 and K2 through their FFT entries alone, K4 not at all."""
    require_variants(run, {"stft_kernel": "fft", "istft_kernel": "fft"})
    count_off_path(rows, run)


def stream_low_latency(torch, rng, rows, tmp, base):
    """3c (1): ``--stream_latency_ms 224`` sessions, bf16 over HTTP; the
    same session in fp32 on the card against the CPU."""
    from audiodenoiser_torch.eval.streaming import LowLatencyStreamingDenoiser
    from audiodenoiser_torch.ops.cuda import reset_launch_counts

    import numpy as np

    service, server, url = _serve(base + ["--stream_latency_ms", "224"])
    try:
        signal = _signal(rng, 3 * SR)
        reset_launch_counts()
        t0 = time.perf_counter()
        info = _start(url)
        packets = _ragged(len(signal), 1)
        out = _feed(url, info["session"], signal, packets)
        wall = time.perf_counter() - t0
        print(f"[stream] low-latency 224 ms: latency_samples {info['latency_samples']}, "
              f"{len(packets)} packets, {len(out)} of {len(signal)} samples out in "
              f"{wall:.3f} s", flush=True)
        check(info["latency_samples"] == 1792, f"low-latency /stream/start: {info}")
        check(len(out) == len(signal) and bool(np.isfinite(out).all()),
              "the low-latency session did not return as many samples as it was fed")
        _stream_kernels(rows, "the low-latency HTTP session")
    finally:
        server.shutdown()
        server.server_close()
    short = _signal(rng, 2048)
    outs = {}
    for dev in ("cuda", "cpu"):
        runner = _cpu_runner(tmp) if dev == "cpu" else _card_runner(tmp, torch.float32)
        engine = LowLatencyStreamingDenoiser.from_latency_budget(runner, 224)
        outs[dev] = _session_out(engine.session(), short, (700, 1348))
    rel = _rel(outs["cuda"], outs["cpu"])
    print(f"[stream] low-latency fp32 session (2048 samples, 4 windows) card vs CPU: "
          f"rel_err {rel:.3e}", flush=True)
    check(len(outs["cuda"]) == len(short) and rel < STREAM_TOL,
          "fp32 low-latency session card vs CPU")


def _card_runner(d: str, dtype):
    from audiodenoiser_torch.eval.runner import DenoiserRunner, load_model_for_noise

    return DenoiserRunner(load_model_for_noise("mixed", d, dtype=dtype, device="cuda",
                                               stem="mask_denoiser"), device="cuda")


def stream_pool(torch, rng, rows, tmp, service, server, url):
    """3c (2): 8 concurrent HTTP sessions in a pool of 8 (fp32), each
    against a dedicated session on the same runner; a 9th start is a 503
    until a flush frees a slot. Then the bf16 pool's gap, printed."""
    import numpy as np

    from audiodenoiser_torch.eval.streaming import MultiStreamWola, StreamingDenoiser
    from audiodenoiser_torch.ops.cuda import reset_launch_counts, stft_kernel

    gen = server.current_generation()
    pool = gen["pooled"].pool
    check(pool.capacity == 8 and gen["gen"] == 0, f"pool {pool.capacity}, gen {gen['gen']}")
    signals = [_signal(rng, 3 * SR - 1000 * i) for i in range(8)]
    packets = [_ragged(len(x), 10 + i) for i, x in enumerate(signals)]
    sids = [_start(url)["session"] for _ in signals]
    code, body = _http_code(url, "/stream/start")
    check(code == 503 and "pool full" in body, f"a 9th session on a pool of 8: {code} {body}")
    reset_launch_counts()
    results, errors = {}, []

    def run(i):
        try:
            results[i] = _feed(url, sids[i], signals[i], packets[i])
        except Exception as e:  # reported by the check below
            errors.append(f"{type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        check(not t.is_alive(), "a pooled session never finished")
    wall = time.perf_counter() - t0
    check(not errors, f"pooled sessions failed: {errors}")
    k1 = stft_kernel.launches
    hops = sum(-(-(len(x) + pool.chunk) // pool.hop) for x in signals)
    print(f"[stream] pool of 8, 8 concurrent HTTP sessions: {pool.advances} advances for "
          f"{hops} session hops, K1 launched {k1} times, in {wall:.3f} s", flush=True)
    check(pool.advances < hops and k1 == pool.advances,
          "the pool did not batch the sessions' hops")
    _stream_kernels(rows, "the pooled HTTP sessions")
    streamer = StreamingDenoiser(service.runner, chunk_samples=pool.chunk)
    gaps = [_rel(results[i], _session_out(streamer.session(), x, packets[i]))
            for i, x in enumerate(signals)]
    print(f"[stream] fp32 pooled vs dedicated session, worst rel_err {max(gaps):.3e}",
          flush=True)
    check(all(len(results[i]) == len(x) for i, x in enumerate(signals)),
          "a pooled session did not return as many samples as it was fed")
    check(max(gaps) < STREAM_TOL, "fp32 pooled sessions disagree with dedicated ones")
    info = _start(url)  # a flushed slot is reused
    check(len(_feed(url, info["session"], signals[0][:5000], (5000,))) == 5000,
          "a reused pool slot")
    # bf16, measured only: a slot's window runs in a batch of 8, cuDNN's
    # kernels for which round otherwise than batch 1's (ROADMAP C.1)
    runner = _card_runner(tmp, torch.bfloat16)
    bf_pool = MultiStreamWola(runner, capacity=8, chunk_samples=pool.chunk)
    slots = [bf_pool.open() for _ in signals]
    outs = {s: [bf_pool.process({s: x})[s]] for s, x in zip(slots, signals)}
    streamer = StreamingDenoiser(runner, chunk_samples=pool.chunk)
    gaps = [_rel(np.concatenate(outs[s] + [bf_pool.flush(s)]),
                 _session_out(streamer.session(), x, (len(x),)))
            for s, x in zip(slots, signals)]
    print(f"[stream] bf16 pooled vs dedicated session (not checked): worst rel_err "
          f"{max(gaps):.3e}", flush=True)


def stream_pool_auto(base):
    """3c (3): ``--stream_pool auto``: the capacity and the probe bytes."""
    from audiodenoiser_torch.cli.serve import build_generation, parse_args
    from audiodenoiser_torch.eval.streaming import _peak_bytes

    gen = build_generation(parse_args(base + ["--stream_pool", "auto"]))
    pool = gen["pooled"].pool
    probe = _peak_bytes(gen["runner"], pool.chunk)
    sizes = {c: probe(c) for c in (2, 8)}
    print(f"[stream] --stream_pool auto: capacity {pool.capacity}; probe peak bytes "
          f"{sizes} (torch.cuda.max_memory_allocated a denoise)", flush=True)
    check(pool.capacity >= 8, f"--stream_pool auto chose {pool.capacity} on an 80 GB card")
    del gen, pool


def stream_16k(torch, rng, rows, tmp, url):
    """3c (4): a ``?rate=16000`` client, sample-exact, and its fp32 stream
    against the CPU's run of the same session."""
    from audiodenoiser_torch.eval.streaming import ResampledStreamingSession, StreamingDenoiser
    from audiodenoiser_torch.ops.cuda import reset_launch_counts

    signal = _signal(rng, 16001)
    packets = _ragged(len(signal), 3)
    reset_launch_counts()
    info = _start(url, "?rate=16000")
    out = _feed(url, info["session"], signal, packets)
    _stream_kernels(rows, "the 16 kHz session")
    cpu = StreamingDenoiser(_cpu_runner(tmp), chunk_samples=2 * SR)
    ref = _session_out(ResampledStreamingSession(cpu.session(), 16000, SR), signal, packets)
    rel = _rel(out, ref)
    print(f"[stream] 16 kHz client: sample_rate {info['sample_rate']}, {len(out)} of "
          f"{len(signal)} samples; fp32 card (pooled) vs CPU rel_err {rel:.3e}", flush=True)
    check(info["sample_rate"] == 16000 and len(out) == len(signal), "the 16 kHz session")
    check(rel < STREAM_TOL, "the 16 kHz session card vs CPU")


def stream_reload(torch, rng, rows, tmp, service, url):
    """3c (5): ``POST /admin/reload`` of a second export: generations, old
    and new sessions, a request, and a failed reload."""
    import numpy as np

    from audiodenoiser_torch.data.wav_io import read_wav
    from audiodenoiser_torch.eval.streaming import StreamingDenoiser
    from audiodenoiser_torch.models import random_flax_variables

    old_runner = service.runner
    signal = _signal(rng, 20000)
    before = _start(url)
    head = _feed(url, before["session"], signal, (9000,), flush=False)
    _write_mask_export(tmp, random_flax_variables(5, in_channels=3, out_channels=2))
    t0 = time.perf_counter()
    code, body = _http_code(url, "/admin/reload")
    reload_s = time.perf_counter() - t0
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    print(f"[stream] /admin/reload: {code} {body} in {reload_s:.2f} s; /healthz "
          f"model_generation {health['model_generation']}", flush=True)
    check(code == 200 and json.loads(body)["generation"] == 1
          and health["model_generation"] == 1, "the reload did not make generation 1")
    new_runner = service.runner
    check(new_runner is not old_runner, "the reload kept the old runner")
    tail = _feed(url, before["session"], signal[9000:], (len(signal) - 9000,))
    after = _start(url)
    fresh = _feed(url, after["session"], signal, (7000, 13000))
    clip = _signal(rng, int(1.7 * SR))
    answer = _post(url, _wav(clip))
    sent = read_wav(io.BytesIO(_wav(clip)))[0]
    padded = np.zeros((1, service._bucket_len(len(sent))), np.float32)
    padded[0, : len(sent)] = sent
    want_old = _session_out(StreamingDenoiser(old_runner, 2 * SR).session(), signal,
                            (9000, len(signal) - 9000))
    want_new = _session_out(StreamingDenoiser(new_runner, 2 * SR).session(), signal,
                            (7000, 13000))
    direct = new_runner.denoise_audio(torch.from_numpy(padded))[0, : len(sent)]
    old_gap = _rel(np.concatenate([head, tail]), want_old)
    new_gap = _rel(fresh, want_new)
    models_gap = _rel(want_new, want_old)
    print(f"[stream] session opened before the reload: generation {before['generation']}, "
          f"rel_err vs the old model {old_gap:.3e}; after: generation {after['generation']}, "
          f"rel_err vs the new model {new_gap:.3e}; the two models' outputs differ by "
          f"{models_gap:.3e}", flush=True)
    check(before["generation"] == 0 and after["generation"] == 1, "session generations")
    check(old_gap < STREAM_TOL and new_gap < STREAM_TOL and models_gap > 100 * STREAM_TOL,
          "sessions across the reload did not keep their generation's model")
    check_answer("/denoise after the reload", sent, answer, direct)
    with open(os.path.join(tmp, "mask_denoiser_mixed.ckpt"), "wb") as f:
        f.write(b"not a checkpoint")
    code, body = _http_code(url, "/admin/reload")
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    print(f"[stream] reload of an unreadable checkpoint: {code} {body[:120]}; "
          f"model_generation {health['model_generation']}", flush=True)
    check(code == 500 and health["model_generation"] == 1 and service.runner is new_runner,
          "a failed reload changed the serving generation")
    check_answer("/denoise after a failed reload", sent, _post(url, _wav(clip)), direct)
    check(_start(url)["generation"] == 1, "a session after a failed reload")


def stream_bench(card):
    """3c (7): the stream benches of ``eval.bench``."""
    from audiodenoiser_torch.eval.bench import stream_benches
    from audiodenoiser_torch.ops.cuda import reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    result = stream_benches(profile_iters=3)
    profiles = {k: result.pop(k) for k in [k for k in result if k.endswith("_profile")]}
    result["card"] = card
    print(f"[stream bench] {json.dumps(result)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    print(f"[stream bench profiles] {json.dumps(profiles)}", flush=True)
    check(all(v > 0 for k, v in result.items() if k != "card"), "a stream bench measured 0")
    require_variants("the stream benches", {"stft_kernel": "fft", "istft_kernel": "fft"})


def phase_stream(torch, rng, rows, mask_variables, card):
    """Phase 3c: streaming and serving of the recommended deployment at full
    width: low-latency sessions, a pool, its automatic size, a 16 kHz
    client, hot reload and the stream benches."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    server = None
    # fp32 convolutions in full fp32, not TF32, in the server's threads too
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _write_mask_export(tmp, mask_variables)
        base = ["--model", "complex_mask", "--noise_type", "mixed", "--saved_models_dir", tmp,
                "--port", "0", "--max_seconds", "10"]
        stream_low_latency(torch, rng, rows, tmp, base)
        service, server, url = _serve(base + ["--precision", "f32", "--stream_pool", "8"])
        stream_pool(torch, rng, rows, tmp, service, server, url)
        stream_pool_auto(base)
        stream_16k(torch, rng, rows, tmp, url)
        stream_reload(torch, rng, rows, tmp, service, url)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        if server is not None:
            server.shutdown()
            server.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    stream_bench(card)


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
    """Phase 2, K3: the kernel against its plain version at the shapes of
    ``DECONV_SETS``, bf16 and fp32, forward and backward; times in bf16.
    Returns the kernels-line row, timed over one training step's four
    upsamplings (launches filled in by the training phase)."""
    import torch.nn.functional as F

    from audiodenoiser_torch.ops.cuda import (
        conv_transpose_2x2,
        conv_transpose_2x2_plain,
        deconv_kernel,
        variant_launches,
    )

    dev = torch.device("cuda")
    totals = {label: {} for label, _ in DECONV_SETS}
    train_err = 0.0
    for label, shapes in DECONV_SETS:
        for b, cin, h, w, cout in shapes:
            x32 = torch.from_numpy(rng.standard_normal((b, h, w, cin), dtype="float32")).to(dev)
            x32 = x32.permute(0, 3, 1, 2)  # logical NCHW, channels_last memory
            wt = torch.from_numpy((rng.standard_normal((cin, cout, 2, 2)) / math.sqrt(cin))
                                  .astype("float32")).to(dev)
            bias = torch.from_numpy(rng.standard_normal(cout).astype("float32")).to(dev)
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                before = variant_launches(deconv_kernel)
                ours = deconv_kernel(x, wt, bias)
                variant = "fma" if dtype == torch.float32 else "wgmma"
                check(variant_launches(deconv_kernel)[variant] == before[variant] + 1,
                      f"K3 {dtype} at {(b, cin, h, w, cout)} did not take its {variant} variant")
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
            times = timings(lambda: deconv_kernel(xb, wt, bias),
                            lambda: conv_transpose_2x2_plain(xb, wt, bias),
                            lambda: F.conv_transpose2d(xb, wb_cl, bb, stride=2), plain_reps=5)
            bound, bound_by = deconv_bound_ms([(b, cin, h, w, cout)], 2)
            for k, t in times.items():
                totals[label][k] = totals[label].get(k, 0.0) + t
            print(f"[kernels] deconv_kernel {label} B={b} Cin={cin} H={h} W={w} "
                  f"Cout={cout}: f32 max_rel_err={errs['float32'][1]:.3e} bf16 "
                  f"max_rel_err={errs['bfloat16'][1]:.3e} grad_rel_l2={gerr:.3e}; bf16 "
                  f"{show(times)} bound_ms={bound:.4f} ({bound_by})", flush=True)
            del x32, xb
            torch.cuda.empty_cache()
    for label, shapes in DECONV_SETS:
        bound, bound_by = deconv_bound_ms(shapes, 2)
        totals[label].update(bound_ms=bound, bound_by=bound_by)
        print(f"[kernels] deconv_kernel {label}, four upsamplings: "
              f"{show({k: v for k, v in totals[label].items() if k != 'bound_by'})} "
              f"({bound_by})", flush=True)
    print(f"[kernels] K3 variants used in phase 2: {variant_launches(deconv_kernel)}", flush=True)
    return {"name": "deconv_kernel", "route": "cuda",
            "source": "audiodenoiser_torch/csrc/deconv_kernel.cu",
            "replaces": "audiodenoiser_tpu/ops/pallas/deconv_kernel.py:117",
            "max_abs_err": train_err, **totals["train"],
            "student_shapes": totals["student"],
            "s2d_shapes": {"mask_step": totals["s2d_mask"], "crop_step": totals["s2d_crop"]}}


def batch_conv_shapes(n=256, features=(64, 128, 256, 512), bottleneck=1024, f=257, t=126):
    """(B, Cin, Cout, H, W) of the 18 ReLU'd convolutions of a folded U-Net
    forward on n clips of an f x t spectrogram (down, bottleneck, up)."""
    down, c = [], 1
    for fe in features:
        down += [(c, fe, f, t), (fe, fe, f, t)]
        c, f, t = fe, f // 2, t // 2
    mid = [(c, bottleneck, f, t), (bottleneck, bottleneck, f, t)]
    up = [s for cin, fe, f, t in down[-1::-2] for s in ((2 * fe, fe, f, t), (fe, fe, f, t))]
    return [(n, *s) for s in down + mid + up]


def phase_fused_conv(torch, rng):
    """Phase 2, the folded conv's two routes at the 18 ReLU'd conv shapes of
    a 256-clip batch in bf16: cuDNN's fused conv + bias + ReLU (the route
    ``models.folded._Conv`` takes on the card) against conv(+bias) then
    ReLU. Each shape's first call (host clock, synchronised: plan building
    included) and its time a call (events and device), summed over the
    18 to a batch's."""
    import torch.nn.functional as F

    from audiodenoiser_torch.models.folded import _Conv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    total = {}
    first = {"fused_first_ms": 0.0, "plain_first_ms": 0.0}
    for b, cin, cout, h, w in batch_conv_shapes():
        x = (torch.randn(b, cin, h, w, device=dev, generator=gen).relu().to(torch.bfloat16)
             .contiguous(memory_format=torch.channels_last))
        wt = torch.randn(cout, cin, 3, 3, device=dev, generator=gen) * math.sqrt(2 / (9 * cin))
        conv = _Conv(wt.to(torch.bfloat16), 0.1 * torch.randn(cout, device=dev, generator=gen))
        bias = conv.bias.to(torch.bfloat16)

        def plain():
            return F.relu(F.conv2d(x, conv.weight, bias, padding=1))

        ms = {}
        with torch.no_grad():
            for name, fn in (("fused", conv), ("plain", plain)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(x) if fn is conv else fn()
                torch.cuda.synchronize()
                ms[f"{name}_first_ms"] = 1e3 * (time.perf_counter() - t0)
            before = _Conv.fused_launches
            got, want = conv(x).float(), plain().float()
            check(_Conv.fused_launches == before + 1, "the folded conv did not take the fused route")
            rel = ((got - want).norm() / want.norm()).item()
            check(rel <= 1e-2, f"fused conv at {(b, cin, cout, h, w)} is {rel:.3e} from plain")
            del got, want
            for name, fn in (("fused", lambda: conv(x)), ("plain", plain)):
                ms[f"{name}_ms"] = time_ms(fn, 10)
                ms[f"{name}_device_ms"] = device_ms(fn, 5)
        for k, v in ms.items():
            (first if k.endswith("first_ms") else total)[k] = (
                (first if k.endswith("first_ms") else total).get(k, 0.0) + v)
        print(f"[fused_conv] B={b} Cin={cin} Cout={cout} H={h} W={w}: {show(ms)} "
              f"rel_l2_vs_plain={rel:.3e}", flush=True)
        del x
        torch.cuda.empty_cache()
    line = {"batch_shapes": 18, **total, **first,
            "fused_calls_counted": _Conv.fused_launches}
    print(f"[fused_conv] {json.dumps(line)}", flush=True)
    return line


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
        # bf16 frames: loaded as bf16, summed in fp32, rounded once, as the
        # plain version does; the two fp32 sums may round one bf16 ulp apart
        fb = frames.to(torch.bfloat16)
        ours_b, ref_b = overlap_add_kernel(fb, hop), overlap_add_plain(fb, hop)
        torch.cuda.synchronize()
        out_len = (n_frames - 1) * hop + n_fft
        check(ours.shape == ref.shape == (batch, out_len), f"K4 shape {tuple(ours.shape)}")
        check(ours_b.dtype == torch.bfloat16 and ours_b.shape == ours.shape, "K4 bf16 output")
        err = (ours - ref).abs().max().item()
        scale = ref.abs().max().item()
        err_b = (ours_b.float() - ref_b.float()).abs().max().item()
        scale_b = ref_b.float().abs().max().item()
        worst = max(worst, err)
        print(f"[kernels] overlap_add_kernel B={batch} T={n_frames} n_fft={n_fft} "
              f"hop={hop}: max_abs_err={err:.3e} max_rel_err={err / scale:.3e}; bf16 "
              f"max_rel_err={err_b / scale_b:.3e}", flush=True)
        check(err <= KERNEL_TOL * scale, f"K4 disagrees with plain at hop {hop}")
        check(err_b <= 2.0 ** -7 * scale_b, f"K4 bf16 disagrees with plain at hop {hop}")
        if row is not None:
            continue

        def fold():
            return F.fold(frames.transpose(1, 2), (1, out_len), (1, n_fft),
                          stride=(1, hop)).reshape(batch, out_len)

        check((fold() - ref).abs().max().item() <= KERNEL_TOL * scale,
              "F.fold yardstick disagrees")
        times = timings(lambda: overlap_add_kernel(frames, hop),
                        lambda: overlap_add_plain(frames, hop), fold)
        bf16_ms = device_ms(lambda: overlap_add_kernel(fb, hop))
        bound, bound_by = ola_bound_ms(batch, n_frames, n_fft, hop)
        print(f"[kernels] overlap_add_kernel bench: {show(times)} bound_ms={bound:.4f} "
              f"({bound_by}); bf16 device_ms={bf16_ms:.4f} (bound {bound / 2:.4f}, half "
              f"the bytes)", flush=True)
        row = {"name": "overlap_add_kernel", "route": "cuda",
               "source": "audiodenoiser_torch/csrc/overlap_add_kernel.cu",
               "replaces": "audiodenoiser_tpu/ops/pallas/overlap_add_kernel.py:58",
               "max_abs_err": 0.0, "bound_ms": bound, "bound_by": bound_by, **times}
    row["max_abs_err"] = worst
    return row


LN_SHAPE = (3200, 1601, 64)  # the MP-SENet cell's time half: 32 x 100 bins x 1,601 frames


def bf16_gap(got, want) -> tuple[float, float]:
    """Largest |got - want| in bf16 ulps of the pair's larger magnitude, and
    in units of that ulp plus 2**-20 of ``want``'s largest magnitude (16
    float32 roundings): where the float32 value both round once cancels to
    near 0, a fused multiply-add and separate products differ by float32
    rounding, which is many ulps of a tiny output (tests/test_torch_cuda.py)."""
    import torch

    got, want = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), e - 8)
    gap = (got - want).abs()
    return float((gap / ulp).max()), float((gap / (ulp + 2.0 ** -20 * want.abs().max())).max())


def phase_layer_norm(torch, rng):
    """Phase 2, the row LayerNorm (MP-SENet's conformer norms; no TPU
    kernel): the kernel against its plain version and ``F.layer_norm`` at
    the cell's shape in bf16 (within one bf16 ulp beside float32's
    rounding, ``bf16_gap``), timed beside its byte bound, the plain version
    and ``F.layer_norm`` as ``library_ms`` (the yardstick; the port never
    calls it)."""
    import torch.nn.functional as F

    from audiodenoiser_torch.ops.cuda import layer_norm_kernel, layer_norm_plain

    dev, c = torch.device("cuda"), LN_SHAPE[-1]
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))
    x = (torch.randn(LN_SHAPE, generator=gen, device=dev) * 3
         + 5 * torch.randn(LN_SHAPE[:-1] + (1,), generator=gen, device=dev)).to(torch.bfloat16)
    w = (1 + 0.5 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
    b = (0.3 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
    with torch.inference_mode():
        ours = layer_norm_kernel(x, w, b, 1e-5)
        plain = layer_norm_plain(x, w, b, 1e-5)
        library = F.layer_norm(x, (c,), w, b, 1e-5)
        torch.cuda.synchronize()
        (ulps, gap), (lib_ulps, lib_gap) = bf16_gap(ours, plain), bf16_gap(ours, library)
        del plain, library
        times = timings(lambda: layer_norm_kernel(x, w, b, 1e-5),
                        lambda: layer_norm_plain(x, w, b, 1e-5),
                        lambda: F.layer_norm(x, (c,), w, b, 1e-5))
    nbytes = 2 * 2 * x.numel() + 2 * 2 * c
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"[kernels] layer_norm_kernel {x.numel() // c} x {c} bf16: {show(times)} "
          f"bound_ms={bound:.4f} (bytes) share_of_bound={bound / times['device_ms']:.3f}; "
          f"bf16 ulps (beside float32 rounding) vs plain {ulps:.0f} ({gap:.3f}), vs "
          f"F.layer_norm {lib_ulps:.0f} ({lib_gap:.3f})", flush=True)
    check(gap <= 1.0, f"layer_norm_kernel is {gap} bf16 ulps from its plain version")
    check(lib_gap <= 1.0, f"layer_norm_kernel is {lib_gap} bf16 ulps from F.layer_norm")
    return {"name": "layer_norm_kernel", "route": "cuda",
            "source": "audiodenoiser_torch/csrc/layer_norm_kernel.cu",
            "replaces": "none (MP-SENet's conformer LayerNorm; the model exists only in the port)",
            "max_bf16_ulps": ulps, "max_bf16_gap": gap, "bound_ms": bound,
            "bound_by": "bytes", **times}


# the conv modules' first pointwise outputs in the MP-SENet cell: the time
# conformer's 32 x 100 bins of 1,601 frames, the frequency conformer's
# 32 x 1,601 frames of 100 bins (a 288-position tile spans about 2.5 of its
# sequences); the row keeps the first, with the second under "other_shapes"
CM_SHAPES = {"time": (3200, 1601, 256), "freq": (51232, 100, 256)}


def phase_conv_module(torch, rng):
    """Phase 2, the conv module's kernel (MP-SENet's GLU, depthwise k=31,
    BatchNorm and SiLU; no TPU kernel): the kernel against its plain
    version at both conformers' shapes in bf16 (within one bf16 ulp
    beside float32's rounding, ``bf16_gap``), each timed beside its byte
    bound, the plain version and PyTorch's six passes (GLU, the transposed
    copy, the depthwise conv, BatchNorm, SiLU, the copy back) as
    ``library_ms`` (the yardstick; the port never calls it)."""
    import torch.nn.functional as F

    from audiodenoiser_torch.ops.cuda import conv_module_kernel, conv_module_plain

    dev, row = torch.device("cuda"), None
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))

    def rand(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    for label, shape in CM_SHAPES.items():
        c = shape[-1] // 2
        h = rand(*shape, scale=2.0)
        var = (0.3 + torch.rand(c, generator=gen, device=dev)).to(torch.bfloat16)
        params = (rand(c, 1, 31, scale=0.2), rand(c, scale=0.1), rand(c, scale=0.3, shift=1.0),
                  rand(c, scale=0.2), rand(c, scale=0.5), var)
        w, b, bn_w, bn_b, mean, _ = params

        def library():
            y = F.conv1d(F.glu(h, dim=-1).transpose(1, 2), w, b, padding=15, groups=c)
            y = F.silu(F.batch_norm(y, mean, var, bn_w, bn_b, False, 0.0, 1e-5))
            return y.transpose(1, 2).contiguous()

        with torch.inference_mode():
            ours = conv_module_kernel(h, *params, 1e-5)
            plain = conv_module_plain(h, *params, 1e-5)
            torch.cuda.synchronize()
            (ulps, gap), (lib_ulps, lib_gap) = bf16_gap(ours, plain), bf16_gap(ours, library())
            del plain
            times = timings(lambda: conv_module_kernel(h, *params, 1e-5),
                            lambda: conv_module_plain(h, *params, 1e-5), library, plain_reps=5)
        nbytes = 2 * (h.numel() + ours.numel()) + 2 * c * 36
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        print(f"[kernels] conv_module_kernel {label} {shape[0]} x {shape[1]} x {shape[2]} bf16: "
              f"{show(times)} bound_ms={bound:.4f} (bytes) "
              f"share_of_bound={bound / times['device_ms']:.3f}; bf16 ulps (beside float32 "
              f"rounding) vs plain {ulps:.0f} ({gap:.3f}), vs PyTorch's six passes "
              f"{lib_ulps:.0f} ({lib_gap:.3f})", flush=True)
        check(gap <= 1.0, f"conv_module_kernel is {gap} bf16 ulps from its plain version at the "
                          f"{label} shape")
        figures = {"max_bf16_ulps": ulps, "max_bf16_gap": gap, "library_bf16_gap": lib_gap,
                   "bound_ms": bound, "bound_by": "bytes", **times}
        del h, ours
        if row is not None:
            row.setdefault("other_shapes", {})[label] = figures
            continue
        row = {"name": "conv_module_kernel", "route": "cuda",
               "source": "audiodenoiser_torch/csrc/conv_module_kernel.cu",
               "replaces": "none (MP-SENet's conformer conv module; the model exists only in "
                           "the port)", **figures}
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
    from audiodenoiser_torch.data.synth import synth_chunks
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


def check_weight_packs(torch, model) -> None:
    """After ``fit``'s optimizer steps (torch's AdamW, foreach on the card):
    each upsampling's cached wgmma weight pack must equal a fresh pack of
    the weight as it now is, and a K3 forward on it must agree with the
    plain version. A pack left stale by a step would fail both."""
    from audiodenoiser_torch.models.unet import ConvTranspose2x2
    from audiodenoiser_torch.ops.cuda import conv_transpose_2x2_plain, deconv_kernel
    from audiodenoiser_torch.ops.cuda.deconv import packed_weight

    shapes = {s[1]: s for s in DECONV_TRAIN}
    ups = [m for m in model.modules() if isinstance(m, ConvTranspose2x2)]
    check(len(ups) == 4 and all(m.kernel for m in ups), "fit's model lacks its four K3 layers")
    dev = ups[0].weight.device
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    with torch.no_grad():
        for up in ups:
            b, cin, h, w, cout = shapes[up.in_channels]
            wt = up.weight.detach()
            fresh = wt.permute(2, 3, 1, 0).reshape(4 * cout, cin).to(torch.bfloat16)
            check(torch.equal(packed_weight(up.weight, torch.bfloat16, True), fresh),
                  f"K3's weight pack at Cin={cin} is stale after fit's optimizer steps")
            x = torch.randn((b, cin, h, w), generator=gen, device=dev).to(torch.bfloat16)
            x = x.contiguous(memory_format=torch.channels_last)
            ours = deconv_kernel(x, up.weight, up.bias).float()
            ref = conv_transpose_2x2_plain(x.float(), wt.to(torch.bfloat16).float(), up.bias)
            rel = ((ours - ref).abs().max() / ref.abs().max()).item()
            check(rel <= 1e-2, f"K3 after fit disagrees with plain at Cin={cin}: {rel:.3e}")
            worst = max(worst, rel)
    print(f"[train fit] K3 weight packs equal fresh packs of the trained weights; forward "
          f"vs plain max_rel_err {worst:.3e}", flush=True)


def phase_train_fit(torch, rows, tmp):
    """Phase 6: ``fit`` at full width in bf16 with K3 and the on-device
    mixer (K1), the export served, then a few more train steps."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.eval.runner import DenoiserRunner, load_model_for_noise
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.ops.cuda import deconv_kernel, reset_launch_counts, stft_kernel
    from audiodenoiser_torch.data.synth import synth_chunks
    from audiodenoiser_torch.train.loop import FitConfig, create_train_state, fit, train_step

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
    rows["deconv_kernel"]["variant_launches"] = require_variants(
        "fit", {"stft_kernel": "fft", "deconv_kernel": "wgmma"})["deconv_kernel"]
    count_off_path(rows, "fit")
    check_weight_packs(torch, res["state"].model)

    saved = os.path.join(tmp, "saved")
    os.makedirs(saved, exist_ok=True)
    shutil.copyfile(res["best_path"], os.path.join(saved, "unet_denoiser_white.ckpt"))
    runner = DenoiserRunner(load_model_for_noise("white", saved))
    clip = torch.from_numpy(chunks[-1:])
    out = runner.denoise_audio(clip).float().cpu()
    check(out.shape == clip.shape and bool(torch.isfinite(out).all()),
          "the exported model did not denoise a clip")
    print(f"[train fit] export served: 2 s clip, output rms "
          f"{out.square().mean().sqrt().item():.4f}", flush=True)

    # mixer + forward + loss + backward + AdamW; cmask31m.train16 times the step
    reset_launch_counts()
    state, mixer = factory(), OnDeviceMixer(synth_chunks(64, 0), "white")
    for _ in range(3):
        losses = train_step(state, *mixer.sample(gen, batch))[1]
    require_variants("the steady training steps",
                     {"stft_kernel": "fft", "deconv_kernel": "wgmma"})
    print(f"[train] 3 more steps at batch {batch}, last loss {float(losses.total):.5f}",
          flush=True)
    check(math.isfinite(float(losses.total)), "non-finite loss in the steady steps")


def _write_wav_dir(path: str, n_files: int, seconds: float = 4.0):
    from audiodenoiser_torch.data.wav_io import write_wav
    from audiodenoiser_torch.data.synth import synth_chunks

    os.makedirs(path, exist_ok=True)
    for i, chunk in enumerate(synth_chunks(2 * n_files, seed=3).reshape(n_files, -1)):
        write_wav(os.path.join(path, f"clean_{i}.wav"), chunk[: int(seconds * SR)], SR)


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
    check(os.path.exists(os.path.join(export, "unet_denoiser_white.ckpt")),
          "cli.train wrote no export")
    print(f"[train cli] exit 0 in {time.perf_counter() - t0:.1f} s, export written", flush=True)


MASK_SIDECAR = {"mask_bound": 8.0, "si_sdr_weight": 0.5, "si_sdr_clamp": 30.0,
                "residual": True}  # cli.train's defaults for --noise_type mixed
BN_FED_BIASES = ("double_conv.0.bias", "double_conv.3.bias")


def mask_istft_grad(torch, rng):
    """Phase 6c (a): K2's gradient (K1 on the cotangent) at the mask step's
    shape against autograd through the plain iSTFT on the card; large
    imaginary DC/Nyquist parts get exactly 0."""
    from audiodenoiser_torch.dsp.stft import istft
    from audiodenoiser_torch.ops.cuda import istft_kernel, reset_launch_counts, stft_kernel

    parts = rng.standard_normal((16, N_FFT // 2 + 1, 126, 2)).astype("float32")
    parts[:, [0, -1], :, 1] = 50.0
    spec0 = torch.view_as_complex(torch.from_numpy(parts)).cuda()
    g = torch.from_numpy(rng.standard_normal((16, 2 * SR)).astype("float32")).cuda()
    grads = {}
    for precision in ("kernel", "fft"):
        spec = spec0.clone().requires_grad_()
        reset_launch_counts()
        (istft(spec, HOP, n_fft=N_FFT, length=2 * SR, precision=precision) * g).sum().backward()
        torch.cuda.synchronize()
        grads[precision] = torch.view_as_real(spec.grad)
        if precision == "kernel":
            check(stft_kernel.fft_launches == 1 and istft_kernel.fft_launches == 1,
                  "K2's forward and backward did not run K2 and K1 once each")
    ours, ref = grads["kernel"], grads["fft"]
    err = (ours - ref).abs().max().item()
    scale = ref.abs().max().item()
    edge = ours[:, [0, -1], :, 1].abs().max().item()
    print(f"[mask train] K2 gradient vs autograd of istft_plain, B=16 257x126 -> 16000: "
          f"max_abs_err {err:.3e} max_rel_err {err / scale:.3e}; imaginary DC/Nyquist "
          f"gradient max {edge}", flush=True)
    check(err <= 1e-5 * scale, "K2's gradient disagrees with autograd of the plain iSTFT")
    check(edge == 0.0, "K2's gradient reached the imaginary DC/Nyquist parts")


def _mask_mixer(torch, n_chunks, seed, device):
    from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
    from audiodenoiser_torch.data.synth import synth_chunks, synth_noise_clips

    bank = NoiseBank(synth_noise_clips(6, seed + 1), device=device)
    return OnDeviceMixer(synth_chunks(n_chunks, seed), "mixed", noise_bank=bank, device=device)


def _mask_step(torch, widths, variables, noisy, clean, dev):
    """One fp32 mask train step on ``dev`` from ``variables``: its losses,
    its gradients (before the clip) and updated weights by name, the U-Net's
    input and the loss's gradient with respect to the U-Net's output."""
    from torch import nn

    from audiodenoiser_torch.models import ComplexMaskUNet
    from audiodenoiser_torch.train.mask import create_mask_train_state, make_mask_steps

    class Tap(nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x):
            y = self.model(x)
            y.retain_grad()
            self.x, self.y = x, y
            return y

    model = ComplexMaskUNet(**widths, mask_bound=8.0, residual=True, pallas_deconv=True)
    state = create_mask_train_state(0, model, variables=variables, device=dev)
    state.model = tap = Tap(state.model)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        state, losses = make_mask_steps(0.5, 30.0)[0](state, noisy.to(dev), clean.to(dev))
    clip = min(1.0, 1.0 / float(state.grad_norm))  # the step scaled the gradients by it
    return ([float(x) for x in losses],
            {n: (p.grad.detach().cpu() / clip, p.detach().cpu())
             for n, p in model.named_parameters()},
            tap.x.detach().cpu(), tap.y.grad.detach().cpu())


def _f64_grads(torch, widths, variables, x, g):
    """The U-Net's parameter gradients for input ``x`` and output cotangent
    ``g``, in float64 on the card (cuDNN): the arbiter of fp32 gradients."""
    from audiodenoiser_torch.models import ComplexMaskUNet, state_dict_from_flax

    model = ComplexMaskUNet(**widths, mask_bound=8.0, residual=True, dtype=torch.float64)
    model.load_state_dict(state_dict_from_flax(variables))
    model = model.double().cuda().train()
    model(x.double().cuda()).backward(g.double().cuda())
    return {n: p.grad.cpu() for n, p in model.named_parameters()}


def _rel_by_name(torch, ours, ref):
    """Relative L2 by tensor, and over all tensors together, of gradients
    ``ours`` against ``ref``, leaving out the conv biases that feed
    train-mode BN: their gradient is exactly 0, rounding noise on every side."""
    names = [n for n in ref if not n.endswith(BN_FED_BIASES)]
    by_name = {n: float((ours[n].double() - ref[n].double()).norm() / ref[n].double().norm())
               for n in names}
    diff = sum(float((ours[n].double() - ref[n].double()).square().sum()) for n in names)
    total = sum(float(ref[n].double().square().sum()) for n in names)
    return by_name, (diff / total) ** 0.5


def _worst(errs, k=3):
    return ", ".join(f"{n} {e:.3e}" for n, e in sorted(errs.items(), key=lambda kv: -kv[1])[:k])


def mask_step_fp32(torch):
    """Phase 6c (b): one full-width fp32 mask train step on the card (K1, K2
    and its gradient, K3) against the CPU (plain versions), from one weight
    tree and one batch of the mixed mixer's waveforms. Each device's
    parameter gradients are also held to a float64 backward of its own
    cotangent on the card: at full width this step's fp32 gradient is
    ill-conditioned (on both devices), so that arbiter, and not the CPU,
    decides; at the two-level width the card's gradient meets it per tensor."""
    from audiodenoiser_torch.models import ComplexMaskUNet, random_flax_variables
    from audiodenoiser_torch.ops.cuda import (
        deconv_kernel,
        istft_kernel,
        reset_launch_counts,
        stft_kernel,
    )
    from audiodenoiser_torch.train.mask import create_mask_train_state

    variables = random_flax_variables(0, in_channels=3, out_channels=2)
    noisy, clean = _mask_mixer(torch, 8, 4, "cpu").sample_audio(
        torch.Generator().manual_seed(6), 2)
    got = {}
    for dev in ("cuda", "cpu"):
        reset_launch_counts()
        t0 = time.perf_counter()
        got[dev] = (*_mask_step(torch, {}, variables, noisy, clean, dev),
                    time.perf_counter() - t0)
        if dev == "cuda":
            counts = (stft_kernel.launches, istft_kernel.launches, deconv_kernel.launches)
            check(counts == (2, 1, 4), f"the fp32 card mask step launched K1, K2, K3 {counts}")
    (lc, pc, xc, gc, tc), (lp, pp, xp, gp, tp) = got["cuda"], got["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    cot_err = float((gc - gp).norm() / gp.norm())
    card_cpu, card_cpu_all = _rel_by_name(torch, {n: g for n, (g, _) in pc.items()},
                                          {n: g for n, (g, _) in pp.items()})
    weight_err = max(float((pc[n][1] - w).norm() / w.norm()) for n, (_, w) in pp.items())
    f64 = {}
    for dev, x, g, params in (("cuda", xc, gc, pc), ("cpu", xp, gp, pp)):
        f64[dev] = _rel_by_name(torch, {n: gr for n, (gr, _) in params.items()},
                                _f64_grads(torch, {}, variables, x, g))
    # the optimizer alone: the CPU's clipped gradients through the card's AdamW
    state = create_mask_train_state(0, ComplexMaskUNet(mask_bound=8.0, residual=True),
                                    variables=variables, device="cuda")
    for n, p in state.model.named_parameters():
        p.grad = pp[n][0].cuda()  # the optimizer clips them as the CPU's step did
    state.optimizer.step()
    opt_err = max(float((p.detach().cpu() - pp[n][1]).norm() / pp[n][1].norm())
                  for n, p in state.model.named_parameters())
    del state
    print(f"[mask train fp32] full width, card vs CPU (steps {tc:.2f} s / {tp:.2f} s): losses "
          f"{[round(x, 6) for x in lc]} vs {[round(x, 6) for x in lp]} (max rel "
          f"{loss_err:.3e}); the loss's gradient w.r.t. the mask rel L2 {cot_err:.3e}; "
          f"parameter gradients rel L2 {card_cpu_all:.3e} over all, worst {_worst(card_cpu)}; "
          f"updated weights max rel L2 {weight_err:.3e}; the CPU's gradients through the "
          f"card's AdamW vs the CPU's update {opt_err:.3e}", flush=True)
    for dev in ("cuda", "cpu"):
        errs, overall = f64[dev]
        print(f"[mask train fp32] full width, {dev} fp32 gradients vs a float64 backward of "
              f"its own cotangent: rel L2 {overall:.3e} over all, median "
              f"{sorted(errs.values())[len(errs) // 2]:.3e}, worst {_worst(errs)}", flush=True)
    check(all(math.isfinite(x) for x in lc) and loss_err <= TRAIN_TOL, "fp32 mask step losses")
    check(cot_err <= TRAIN_TOL, "fp32 mask step: the loss's gradient w.r.t. the mask")
    check(f64["cuda"][1] <= f64["cpu"][1],
          "fp32 mask step: the card's gradients are further from float64 than the CPU's")
    check(opt_err <= TRAIN_TOL, "fp32 mask step: the card's AdamW")

    # two levels: a width where the card's fp32 gradient meets float64 per
    # tensor; the CPU's, printed only, does not, because two of its ReLU
    # inputs lie within fp32 rounding of zero and a float64 forward takes
    # the other branch there (ROADMAP C.2, tests/test_torch_batchnorm.py)
    narrow = dict(features=(8, 16), bottleneck=32)
    small = random_flax_variables(0, **narrow, in_channels=3, out_channels=2)
    for dev in ("cuda", "cpu"):
        _, params, x, g = _mask_step(torch, narrow, small, noisy, clean, dev)
        errs, overall = _rel_by_name(torch, {n: gr for n, (gr, _) in params.items()},
                                     _f64_grads(torch, narrow, small, x, g))
        print(f"[mask train fp32] two levels (8, 16)/32, {dev} fp32 gradients vs float64: "
              f"rel L2 {overall:.3e} over all, worst {_worst(errs)}", flush=True)
        if dev == "cuda":
            check(max(errs.values()) <= TRAIN_TOL,
                  "fp32 mask step at two levels: the card's gradients vs float64")


def mask_fit(torch, rows, tmp):
    """Phase 6c (c): ``fit`` of the full-width bf16 residual mask model (K3)
    on the mixed mixer's waveforms, its launches, and its ``.ckpt`` served
    by ``cli.serve --model complex_mask``."""
    import numpy as np

    from audiodenoiser_torch.cli.serve import build_server, parse_args
    from audiodenoiser_torch.data.wav_io import read_wav
    from audiodenoiser_torch.models import ComplexMaskUNet
    from audiodenoiser_torch.ops.cuda import (
        deconv_kernel,
        istft_kernel,
        reset_launch_counts,
        stft_kernel,
    )
    from audiodenoiser_torch.train.loop import FitConfig, fit
    from audiodenoiser_torch.train.mask import create_mask_train_state, make_mask_steps

    batch, steps, val_steps, epochs = 16, 10, 2, 2
    mixer, val_mixer = _mask_mixer(torch, 64, 7, "cuda"), _mask_mixer(torch, 8, 9, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = FitConfig(run_name="mask", output_path=os.path.join(tmp, "mask_runs"),
                    epochs=epochs, batch_size=batch, precision="bf16", log_every=10)
    factory = lambda: create_mask_train_state(0, ComplexMaskUNet(
        dtype=torch.bfloat16, pallas_deconv=True, mask_bound=8.0, residual=True,
        zero_out_init=True))
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fit(cfg, lambda e: (mixer.sample_audio(gen, batch) for _ in range(steps)),
              lambda: (val_mixer.sample_audio(gen, batch) for _ in range(val_steps)),
              state_factory=factory, steps=make_mask_steps(0.5, 30.0))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k1, k2, k3 = stft_kernel.launches, istft_kernel.launches, deconv_kernel.launches
    forwards = epochs * (steps + val_steps)
    want = (2 * epochs * steps + epochs * val_steps, forwards, 4 * forwards)
    print(f"[mask train fit] {epochs} epochs x {steps} steps at batch {batch} in {fit_s:.2f} s "
          f"(validation, export and first-step set-up included); history {res['history']}; "
          f"launches K1={k1} K2={k2} K3={k3}, expected {want}", flush=True)
    check(all(math.isfinite(h["train"]) and math.isfinite(h["val"]) for h in res["history"]),
          "non-finite loss in the mask fit")
    check((k1, k2, k3) == want, "the mask fit's K1/K2/K3 launches")
    seen = require_variants("the mask fit", {"stft_kernel": "fft", "istft_kernel": "fft",
                                             "deconv_kernel": "wgmma"})
    for name, n in (("stft_kernel", k1), ("istft_kernel", k2), ("deconv_kernel", k3)):
        rows[name]["mask_train_launches"] = n
        rows[name]["mask_train_variant_launches"] = seen[name]
    count_off_path(rows, "the mask fit")
    check(res["best_path"].endswith("best_model.ckpt"), f"fit exported {res['best_path']}")

    saved = os.path.join(tmp, "mask_saved")
    os.makedirs(saved, exist_ok=True)
    shutil.copyfile(res["best_path"], os.path.join(saved, "mask_denoiser_mixed.ckpt"))
    with open(os.path.join(saved, "mask_denoiser_mixed.json"), "w") as f:
        json.dump(MASK_SIDECAR, f)
    service, server, name = build_server(parse_args([
        "--model", "complex_mask", "--noise_type", "mixed", "--saved_models_dir", saved,
        "--port", "0", "--max_seconds", "10"]))
    try:
        runner = service.runner
        check(name == "mask_denoiser_mixed" and runner.model.mask_bound == 8.0
              and runner.model.mask_residual, "cli.serve did not load the trained mask model")
        url = f"http://127.0.0.1:{server.server_address[1]}"
        threading.Thread(target=server.serve_forever, daemon=True).start()
        clips = [np.clip(mixer.clean[i, : int(s * SR)].cpu().numpy(), -1, 1)
                 for i, s in ((0, 1.3), (1, 2.0))]
        for clip in clips:
            answer = _post(url, _wav(clip), "?mode=complex_mask")
            sent = read_wav(io.BytesIO(_wav(clip)))[0]
            padded = np.zeros((1, service._bucket_len(len(sent))), np.float32)
            padded[0, : len(sent)] = sent
            direct = runner.denoise_audio(torch.from_numpy(padded))[0, : len(sent)]
            check_answer(f"trained mask {len(clip) / SR:.1f} s", sent, answer, direct)
    finally:
        server.shutdown()
        server.server_close()


def mask_cli_start(tmp):
    """Phase 6c (d), started: ``cli.train --model complex_mask --noise_type
    mixed`` on wavs, 1 epoch of 3 steps, in a subprocess."""
    data = os.path.join(tmp, "mask_wavs")
    _write_wav_dir(os.path.join(data, "clean"), 12)
    _noise_wavs(os.path.join(data, "noise"))
    export = os.path.join(tmp, "mask_cli_saved")
    args = ["audiodenoiser_torch.cli.train", "--base_dataset_path", data,
            "--model", "complex_mask", "--pipeline", "on_device", "--noise_type", "mixed",
            "--epochs", "1", "--steps_per_epoch", "3",
            "--output_path", os.path.join(tmp, "mask_cli_runs"), "--export_dir", export]
    return export, _start_cli("mask train cli", args, tmp)


def mask_cli_finish(export, started):
    _, wall = _finish_cli(started)
    ckpt = os.path.join(export, "mask_denoiser_mixed.ckpt")
    sidecar = os.path.join(export, "mask_denoiser_mixed.json")
    check(os.path.exists(ckpt) and os.path.exists(sidecar),
          "cli.train --model complex_mask wrote no .ckpt and sidecar")
    with open(sidecar) as f:
        meta = json.load(f)
    print(f"[mask train cli] exit 0 in {wall:.1f} s; {os.path.getsize(ckpt)} byte .ckpt, "
          f"sidecar {meta}", flush=True)
    check(meta == MASK_SIDECAR, f"cli.train's sidecar {meta} != {MASK_SIDECAR}")


def mask_bench(torch):
    """Phase 6c (e): the bf16 mask train step of the recommended deployment
    (full-width residual ``ComplexMaskUNet``, bound 8, K3) on the ``mixed``
    mixer, over a few steps: its launches a step and a finite loss.
    ``cmask31m.train16`` times the step."""
    from audiodenoiser_torch.models import ComplexMaskUNet
    from audiodenoiser_torch.ops.cuda import (
        deconv_kernel,
        istft_kernel,
        reset_launch_counts,
        stft_kernel,
    )
    from audiodenoiser_torch.train.mask import create_mask_train_state, make_mask_steps

    model = ComplexMaskUNet(dtype=torch.bfloat16, pallas_deconv=True, mask_bound=8.0,
                            residual=True, zero_out_init=True)
    state, mixer = create_mask_train_state(0, model), _mask_mixer(torch, 64, 0, "cuda")
    train_step, _ = make_mask_steps(0.5, 30.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = 3
    reset_launch_counts()
    for _ in range(steps):
        losses = train_step(state, *mixer.sample_audio(gen, 16))[1]
    require_variants("the mask train steps", {"stft_kernel": "fft", "istft_kernel": "fft",
                                              "deconv_kernel": "wgmma"})
    per_step = {k.__name__: k.launches / steps for k in (stft_kernel, istft_kernel, deconv_kernel)}
    print(f"[mask train steps] {steps} at batch 16, last loss {float(losses.total):.5f}; "
          f"launches a step {per_step}", flush=True)
    check(math.isfinite(float(losses.total)), "non-finite loss in the mask train steps")
    check(per_step == {"stft_kernel": 2.0, "istft_kernel": 1.0, "deconv_kernel": 4.0},
          "the mask train step's launches a step")


def phase_mask_train(torch, rng, rows):
    """Phase 6c: complex-mask training on the card."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mask_train_")
    started = None
    try:
        t0 = time.perf_counter()
        export, started = mask_cli_start(tmp)  # beside (a)-(c), to overlap its start
        mask_istft_grad(torch, rng)
        mask_step_fp32(torch)
        mask_fit(torch, rows, tmp)
        mask_cli_finish(export, started)
        mask_bench(torch)
        print(f"[mask train] phase 6c in {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        if started is not None and started[1].poll() is None:  # a check failed first
            started[1].kill()
            started[1].wait()
        shutil.rmtree(tmp, ignore_errors=True)


TRAINSET_FILES = 132  # 4 s wavs: 264 chunks of 2 s, a full device batch of 256 and 8
TRAINSET_TOL = 1e-5   # max |card - CPU| <= TRAINSET_TOL * max |CPU|, per noise type
RESUME_TOL = 1e-6     # relative L2, an uninterrupted fp32 fit against a resumed one
BN_FED = ("double_conv.0.bias", "double_conv.3.bias")  # zero gradient but rounding


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / (b.double().norm() + 1e-30))


def extras_native(torch, tmp):
    """Phase 6d (a): the native loader built with g++ into ``_build/``,
    ``load_batch`` against the scipy path, and ``load_clean_chunks`` through
    it; returns the folders of clean and noise wavs."""
    import numpy as np

    from audiodenoiser_torch.data import builders, native
    from audiodenoiser_torch.data.wav_io import load_wav_list

    clean, noise = os.path.join(tmp, "wavs", "clean"), os.path.join(tmp, "wavs", "noise")
    _write_wav_dir(clean, TRAINSET_FILES)
    _noise_wavs(noise)
    t0 = time.perf_counter()
    check(native.available(), f"the native loader did not build: {native.build_log}")
    build_s = time.perf_counter() - t0
    path = native.library_path()
    check(os.path.dirname(path) == str(native.BUILD_DIR), f"native library at {path}")
    files = load_wav_list(clean)
    t0 = time.perf_counter()
    ours = native.load_batch(files, SR, 2 * SR)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = builders._load_clean_chunks(files, SR, 2 * SR)
    scipy_s = time.perf_counter() - t0
    err = float(np.abs(ours - ref).max()) if ours.shape == ref.shape else math.inf
    before = builders.INGEST_COUNTS["native"]
    builders.load_clean_chunks(files, SR, 2 * SR)
    print(f"[6d native] {os.path.relpath(path, HERE)} ready in {build_s:.2f} s; "
          f"{len(files)} wavs -> {ours.shape} chunks in {native_s * 1e3:.1f} ms (scipy "
          f"{scipy_s * 1e3:.1f} ms), max |native - scipy| {err:.3e}", flush=True)
    check(ours.shape == ref.shape == (2 * TRAINSET_FILES, 2 * SR), "native chunk count")
    check(err <= 1e-6, "the native loader disagrees with the scipy path")
    check(builders.INGEST_COUNTS["native"] == before + 1,
          "load_clean_chunks did not take the native path")
    return clean, noise


def _load_set(root):
    import numpy as np

    return {(nt, f): np.load(os.path.join(root, nt, f))
            for nt in sorted(os.listdir(root)) for f in sorted(os.listdir(os.path.join(root, nt)))}


def extras_dataset(torch, tmp, clean, noise, card):
    """Phase 6d (b): ``cli.create_train_dataset`` in a subprocess on the
    card against a CPU build of the same wavs; returns the set's folder."""
    import numpy as np

    from audiodenoiser_torch.data.builders import build_train_dataset

    out = os.path.join(tmp, "train_processed")
    started = _start_cli(
        "create_train_dataset", ["audiodenoiser_torch.cli.create_train_dataset",
                                 "--clean_dir", clean, "--noise_dir", noise, "--output_base", out,
                                 "--debug_dir", os.path.join(tmp, "debug")], tmp)
    text, wall = _finish_cli(started)
    lines = [l for l in text.splitlines() if l.startswith("[launches] ")]
    check(len(lines) == 1, "cli.create_train_dataset printed no [launches] line")
    report = json.loads(lines[0][len("[launches] "):])
    n = report["chunks"]
    k1 = 2 * 4 * -(-n // 256)
    print(f"[6d dataset] {n} chunks in {report['wall_s']:.2f} s of build "
          f"({report['chunks_per_s']:.1f} chunks/s; {wall:.1f} s with the process's start), "
          f"K1 {report['stft_kernel']} (expected fft {k1}), ingest {report['ingest']}; {card}",
          flush=True)
    check(n == 2 * TRAINSET_FILES, f"{n} chunks, expected {2 * TRAINSET_FILES}")
    check(report["stft_kernel"] == {"fft": k1, "direct": 0}, "K1's launches in the build")
    check(report["ingest"] == {"native": 1, "scipy": 0}, "the build did not ingest natively")
    ours = _load_set(out)
    check(len(ours) == 2 * 4 * n, f"{len(ours)} files, expected {2 * 4 * n}")
    check(all(a.shape == (N_FFT // 2 + 1, 122) and a.dtype == np.float32
              and np.isfinite(a).all() for a in ours.values()), "a file's shape, dtype or values")
    t0 = time.perf_counter()
    build_train_dataset(clean, noise, os.path.join(tmp, "train_cpu"), device="cpu")
    cpu_s = time.perf_counter() - t0
    ref = _load_set(os.path.join(tmp, "train_cpu"))
    check(sorted(ref) == sorted(ours), "the card's and the CPU's file sets differ")
    worst = {}
    for nt in ("white", "urban", "reverb", "noise_cancellation"):
        for kind in ("clean", "noisy") if nt == "reverb" else ("clean",):
            keys = [k for k in ref if k[0] == nt and k[1].startswith(kind)]
            a, b = np.stack([ours[k] for k in keys]), np.stack([ref[k] for k in keys])
            worst[f"{kind}_{nt}"] = float(np.abs(a - b).max() / np.abs(b).max())
    print(f"[6d dataset] card vs CPU build ({cpu_s:.1f} s on the CPU), max|d|/max|ref|: "
          f"{json.dumps(worst)}", flush=True)
    check(max(worst.values()) <= TRAINSET_TOL, "the card's training set disagrees with the CPU's")
    return out


def extras_train_clis(torch, tmp, dataset, clean):
    """Phase 6d (c): ``cli.train --pipeline npy`` on the set with every
    training extra, then ``--resume``; ``cli.train --sample_rate 16000
    --chunk_seconds 1.5`` beside it. Returns the npy run's export folder."""
    wavs16 = os.path.dirname(clean)
    export16 = os.path.join(tmp, "saved16k")
    started16 = _start_cli("train cli 16k", [
        "audiodenoiser_torch.cli.train", "--base_dataset_path", wavs16, "--pipeline",
        "on_device", "--noise_type", "white", "--sample_rate", "16000", "--chunk_seconds", "1.5",
        "--epochs", "1", "--steps_per_epoch", "3", "--output_path", os.path.join(tmp, "runs16k"),
        "--export_dir", export16], tmp)
    export, prof = os.path.join(tmp, "npy_saved"), os.path.join(tmp, "npy_profile")
    base = ["audiodenoiser_torch.cli.train", "--base_dataset_path", dataset, "--noise_type",
            "white", "--run_name", "npy", "--output_path", os.path.join(tmp, "npy_runs"),
            "--export_dir", export, "--lr_schedule", "cosine", "--warmup_steps", "2",
            "--grad_accum", "2", "--ema_decay", "0.999", "--ckpt_every", "1"]
    first, wall1 = _finish_cli(_start_cli("train cli npy", base + [
        "--epochs", "1", "--profile_dir", prof], tmp))
    ckpts = os.path.join(tmp, "npy_runs", "npy", "checkpoints")
    traces = os.listdir(prof) if os.path.isdir(prof) else []
    print(f"[6d train npy] epoch 1 in {wall1:.1f} s; checkpoints {sorted(os.listdir(ckpts))}; "
          f"trace {traces} ({sum(os.path.getsize(os.path.join(prof, t)) for t in traces)} "
          f"bytes)", flush=True)
    check(os.path.exists(os.path.join(export, "unet_denoiser_white.ckpt")),
          "cli.train --pipeline npy shipped no unet_denoiser_white.ckpt")
    check(os.path.exists(os.path.join(ckpts, "best_model_ema.ckpt")), "no best_model_ema.ckpt")
    check(any(t.endswith(".json") for t in traces), "--profile_dir wrote no trace")
    second, wall2 = _finish_cli(_start_cli("train cli npy resume", base + [
        "--epochs", "2", "--resume"], tmp))
    print(f"[6d train npy] resumed in {wall2:.1f} s", flush=True)
    check("Resumed from epoch 1" in second and "Epoch 2/2" in second
          and "Epoch 1/2" not in second, "--resume did not run epoch index 1 alone")
    _, wall16 = _finish_cli(started16)
    with open(os.path.join(export16, "unet_denoiser_white.json")) as f:
        meta = json.load(f)
    print(f"[6d train 16k] exit 0 in {wall16:.1f} s, sidecar {meta}", flush=True)
    check(meta == {"width_mult": 1.0, "sample_rate": 16000}, "the 16 kHz run's sidecar")
    check(os.path.exists(os.path.join(export16, "unet_denoiser_white.ckpt")), "16 kHz export")
    return export


def _serve_once(torch, saved, label):
    """One clip through ``DenoiserRunner`` on ``saved``'s white model,
    K1 and K2 counted."""
    from audiodenoiser_torch.eval.runner import DenoiserRunner, load_model_for_noise
    from audiodenoiser_torch.ops.cuda import istft_kernel, reset_launch_counts, stft_kernel
    from audiodenoiser_torch.data.synth import synth_chunks

    runner = DenoiserRunner(load_model_for_noise("white", saved))
    clip = torch.from_numpy(synth_chunks(1, seed=21))
    reset_launch_counts()
    out = runner.denoise_audio(clip).float().cpu()
    torch.cuda.synchronize()
    print(f"[6d serve] {label}: output rms {out.square().mean().sqrt().item():.4f}, "
          f"K1 {stft_kernel.launches} K2 {istft_kernel.launches}", flush=True)
    check(out.shape == clip.shape and bool(torch.isfinite(out).all()), f"{label} answer")
    check(stft_kernel.launches == 1 and istft_kernel.launches == 1, f"{label}: K1/K2 launches")


def extras_ckpt_clis(torch, tmp, export):
    """Phase 6d (d): the shipped .ckpt answers a request; .ckpt -> .pth ->
    .ckpt is byte-equal; --quantize gives an int8-v1 export that serves."""
    from audiodenoiser_torch.cli import export_checkpoint, import_checkpoint
    from audiodenoiser_torch.train.checkpoints import INT8_FORMAT
    from audiodenoiser_torch.train.msgpack_codec import restore

    _serve_once(torch, export, "cli.train's shipped .ckpt")
    src = os.path.join(export, "unet_denoiser_white.ckpt")
    pth, back = os.path.join(tmp, "round.pth"), os.path.join(tmp, "round.ckpt")
    qdir = os.path.join(tmp, "int8")
    os.makedirs(qdir, exist_ok=True)
    export_checkpoint.main([src, pth])
    import_checkpoint.main([pth, back])
    import_checkpoint.main([pth, os.path.join(qdir, "unet_denoiser_white.ckpt"), "--quantize"])
    with open(src, "rb") as f:
        orig = f.read()
    with open(back, "rb") as f:
        again = f.read()
    with open(os.path.join(qdir, "unet_denoiser_white.ckpt"), "rb") as f:
        q = f.read()
    print(f"[6d ckpt cli] .ckpt {len(orig)} bytes -> .pth {os.path.getsize(pth)} -> .ckpt "
          f"{len(again)} bytes, equal {again == orig}; int8 {len(q)} bytes", flush=True)
    check(again == orig, ".ckpt -> .pth -> .ckpt changed the bytes")
    check(restore(q).get("format") == INT8_FORMAT, "--quantize wrote no int8-v1 export")
    _serve_once(torch, qdir, "the int8 import")


def _mixer_batches(torch, mixer, batch, steps, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [mixer.sample(gen, batch) for _ in range(steps)]


def extras_resume_fp32(torch, tmp):
    """Phase 6d (e): full width fp32, cuDNN deterministic: ``fit`` for 2
    epochs against 1 epoch and a resumed one (grad_accum 2 over 3 steps an
    epoch, so an update spans the resume; warm-up + cosine; EMA 0.999)."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.models import UNet, random_flax_variables
    from audiodenoiser_torch.data.synth import synth_chunks
    from audiodenoiser_torch.train.checkpoints import restore_train_state
    from audiodenoiser_torch.train.loop import FitConfig, create_train_state, fit

    chunks = synth_chunks(16, seed=8)
    mixer, val_mixer = OnDeviceMixer(chunks[:12], "white"), OnDeviceMixer(chunks[12:], "white")
    data = [_mixer_batches(torch, mixer, 4, 3, 100 + e) for e in range(2)]
    val = _mixer_batches(torch, val_mixer, 4, 1, 7)
    variables = random_flax_variables(9)
    root = os.path.join(tmp, "resume")

    def run(name, epochs, resume=False):
        cfg = FitConfig(run_name=name, output_path=root, epochs=epochs, batch_size=4,
                        precision="f32", resume=resume, ema_decay=0.999, log_every=0)
        factory = lambda: create_train_state(0, UNet(pallas_deconv=True), variables=variables,
                                             schedule="cosine", warmup_steps=1,
                                             total_steps=6, grad_accum=2)
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                        allow_tf32=False):
            return fit(cfg, lambda e: iter(data[e]), lambda: iter(val), state_factory=factory)

    t0 = time.perf_counter()
    run("whole", 2)
    run("split", 1)
    resumed = run("split", 2, resume=True)
    wall = time.perf_counter() - t0
    a, b = (restore_train_state(os.path.join(root, r, "checkpoints", "train_state.pt"), "cpu")
            for r in ("whole", "split"))
    # the weights and the EMA are held, but for the conv biases that feed a
    # train-mode BatchNorm: their gradient is rounding alone, which cuDNN's
    # BatchNorm backward sums in an order of its own and AdamW scales to a
    # step; they and the statistics they shift are printed apart
    names = list(a["ema"])
    held = [k for k in names if not k.endswith(BN_FED)]
    flat = lambda d, ks: torch.cat([d[k].flatten() for k in ks])
    errs = {"weights": _rel_l2(flat(b["model"], held), flat(a["model"], held)),
            "ema": _rel_l2(flat(b["ema"], held), flat(a["ema"], held)),
            "bn_fed_biases": _rel_l2(flat(b["model"], [k for k in names if k not in held]),
                                     flat(a["model"], [k for k in names if k not in held])),
            "bn_stats": max(_rel_l2(b["model"][k], a["model"][k]) for k in a["model"]
                            if "running" in k)}
    check(all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"]
              if not a["model"][k].is_floating_point()), "integer buffers differ after resume")
    print(f"[6d resume fp32] 3 fits in {wall:.1f} s; resumed history "
          f"{[h['epoch'] for h in resumed['history']]}; uninterrupted vs resumed rel L2 "
          f"{json.dumps(errs)}", flush=True)
    check([h["epoch"] for h in resumed["history"]] == [1], "the resumed history")
    check(errs["weights"] <= RESUME_TOL and errs["ema"] <= RESUME_TOL,
          "a resumed fit left the uninterrupted one")


def extras_remat_fp32(torch):
    """Phase 6d (f): one full-width fp32 step with remat against one without
    (cuDNN deterministic): loss, gradients, running statistics."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.models import UNet, random_flax_variables
    from audiodenoiser_torch.data.synth import synth_chunks
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    (noisy, clean), = _mixer_batches(torch, OnDeviceMixer(synth_chunks(8, seed=9), "white"),
                                     4, 1, 3)
    variables = random_flax_variables(10)
    got = []
    for remat in (False, True):
        state = create_train_state(0, UNet(pallas_deconv=True, remat=remat),
                                   variables=variables)
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                        allow_tf32=False):
            state, losses = train_step(state, noisy, clean)
        got.append((float(losses.total),
                    {n: p.grad.clone() for n, p in state.model.named_parameters()},
                    {k: v.clone() for k, v in state.model.state_dict().items()}))
        del state
    (l0, g0, s0), (l1, g1, s1) = got
    g_err = max(_rel_l2(g1[n], g0[n]) for n in g0 if not n.endswith(BN_FED))
    s_err = max(_rel_l2(s1[k], s0[k]) for k in s0 if "running" in k)
    counts = {int(s1[k]) - int(s0[k]) for k in s0 if k.endswith("num_batches_tracked")}
    print(f"[6d remat fp32] loss {l1:.6f} vs {l0:.6f}; worst gradient rel L2 {g_err:.3e}; "
          f"worst running stat {s_err:.3e}; num_batches_tracked differences {counts}",
          flush=True)
    check(abs(l1 - l0) <= RESUME_TOL * abs(l0), "remat changed the loss")
    check(g_err <= RESUME_TOL and s_err <= RESUME_TOL, "remat changed a gradient or statistic")
    check(counts == {0} and all(int(s1[k]) == 1 for k in s1 if k.endswith("tracked")),
          "remat folded the running statistics other than once")


def extras_accum_fp32(torch):
    """Phase 6d (g): four full-width fp32 micro-steps under grad_accum 2
    with warm-up + cosine and an EMA, card against CPU on the card's
    batches."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.models import UNet, random_flax_variables
    from audiodenoiser_torch.data.synth import synth_chunks
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    batches = _mixer_batches(torch, OnDeviceMixer(synth_chunks(8, seed=12), "white"), 2, 4, 5)
    variables = random_flax_variables(11)
    got = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(0, UNet(pallas_deconv=True), variables=variables,
                                   device=dev, schedule="cosine", warmup_steps=1,
                                   total_steps=4, grad_accum=2)
        names, params = zip(*state.model.named_parameters())
        p0 = [p.detach().clone() for p in params]
        ema = [p.detach().clone() for p in params]
        losses, t0 = [], time.perf_counter()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for i, (noisy, clean) in enumerate(batches):
                before = [p.detach().clone() for p in params] if i % 2 == 0 else None
                state, out = train_step(state, noisy.to(dev), clean.to(dev))
                with torch.no_grad():
                    torch._foreach_lerp_(ema, list(params), 0.001)
                losses.append(float(out.total))
                if before is not None:
                    check(all(torch.equal(a, b) for a, b in zip(params, before)),
                          f"a non-update micro-step moved the parameters on {dev}")
        keep = [i for i, n in enumerate(names) if not n.endswith(BN_FED)]
        flat = lambda ts: torch.cat([ts[i].detach().float().cpu().flatten() for i in keep])
        got[dev] = (losses, flat(params), flat(ema), flat([p - q for p, q in zip(params, p0)]),
                    {k: v.float().cpu() for k, v in state.model.state_dict().items()
                     if "running" in k}, time.perf_counter() - t0)
        check(state.optimizer.updates == 2, f"{dev}: two updates expected")
        del state
    (lc, pc, ec, dc, sc, tc), (lp, pp, ep, dp, sp, tp) = got["cuda"], got["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    stat_err = max(((sc[k] - sp[k]).abs() / (1.0 + sp[k].abs())).max().item() for k in sp)
    errs = {"losses": loss_err, "params": _rel_l2(pc, pp), "ema": _rel_l2(ec, ep),
            "bn_stats": stat_err, "displacement": _rel_l2(dc, dp)}
    print(f"[6d accum fp32] card {tc:.1f} s, CPU {tp:.1f} s; card vs CPU "
          f"{json.dumps(errs)} (displacement: the updates' own difference, printed)",
          flush=True)
    check(max(errs["losses"], errs["params"], errs["ema"], errs["bn_stats"]) <= TRAIN_TOL,
          "grad_accum steps: the card left the CPU")


def extras_bench(torch, card):
    """Phase 6d (h): bf16 batch 16 with K3: peak memory and step time with
    and without remat, with an EMA and with grad_accum 2."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.data.synth import synth_chunks
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    mixer = OnDeviceMixer(synth_chunks(64, seed=13), "white")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, remat, ema_on, accum in (("plain", False, False, 1), ("remat", True, False, 1),
                                        ("ema", False, True, 1), ("grad_accum2", False, False, 2)):
        state = create_train_state(0, UNet(dtype=torch.bfloat16, pallas_deconv=True,
                                           remat=remat), grad_accum=accum)
        params = list(state.model.parameters())
        ema = [p.detach().clone() for p in params] if ema_on else None

        def step():
            nonlocal state
            noisy, clean = mixer.sample(gen, 16)
            state, _ = train_step(state, noisy, clean)
            if ema is not None:
                with torch.no_grad():
                    torch._foreach_lerp_(ema, params, 0.001)

        for _ in range(4):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        out[label] = {"step_ms": (time.perf_counter() - t0) / 20 * 1e3,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
        del state, params, ema
        torch.cuda.empty_cache()
    print(f"[6d bench] bf16 batch 16, K3, 20 steps after 4: {json.dumps(out)}; {card}",
          flush=True)
    check(out["remat"]["peak_bytes"] < out["plain"]["peak_bytes"], "remat saved no memory")


def extras_mask(torch, tmp):
    """Phase 6d (i): the mask family (bf16, full width, K3) under grad_accum
    2, warm-up + cosine and an EMA, one epoch and then a resumed one: K1
    twice a train step and once a validation step, K2 once a step, K3 four
    times a forward, validation twice an epoch (live and EMA weights)."""
    from audiodenoiser_torch.models import ComplexMaskUNet
    from audiodenoiser_torch.ops.cuda import deconv_kernel, istft_kernel, stft_kernel
    from audiodenoiser_torch.train.loop import FitConfig, fit
    from audiodenoiser_torch.train.mask import create_mask_train_state, make_mask_steps

    mixer = _mask_mixer(torch, 24, 14, "cuda")
    steps, val_steps, batch = 4, 1, 8
    gen = torch.Generator(device="cuda").manual_seed(1)
    factory = lambda: create_mask_train_state(
        0, ComplexMaskUNet(dtype=torch.bfloat16, mask_bound=8.0, residual=True,
                           zero_out_init=True, pallas_deconv=True),
        schedule="cosine", warmup_steps=1, total_steps=2 * steps, grad_accum=2)
    counts = (stft_kernel.launches, istft_kernel.launches, deconv_kernel.launches)
    for epochs, resume in ((1, False), (2, True)):
        cfg = FitConfig(run_name="mask", output_path=os.path.join(tmp, "mask_extras"),
                        epochs=epochs, batch_size=batch, resume=resume, ema_decay=0.999,
                        log_every=0)
        res = fit(cfg, lambda e: (mixer.sample_audio(gen, batch) for _ in range(steps)),
                  lambda: (mixer.sample_audio(gen, batch) for _ in range(val_steps)),
                  state_factory=factory, steps=make_mask_steps(0.5, 30.0))
        check(len(res["history"]) == 1 and all(math.isfinite(v) for v in
                                               res["history"][0].values()), "mask fit")
    torch.cuda.synchronize()
    k1, k2, k3 = (n - c for n, c in zip((stft_kernel.launches, istft_kernel.launches,
                                          deconv_kernel.launches), counts))
    forwards = 2 * (steps + 2 * val_steps)
    want = (2 * (2 * steps + 2 * val_steps), forwards, 4 * forwards)
    print(f"[6d mask] 2 epochs (1 + resumed) of {steps} steps under grad_accum 2 + EMA: "
          f"K1 {k1} K2 {k2} K3 {k3} (expected {want}); EMA export "
          f"{os.path.basename(res['best_ema_path'])}", flush=True)
    check((k1, k2, k3) == want, "the mask family's launches under the training extras")
    check(os.path.exists(res["best_ema_path"]), "the mask fit exported no EMA model")


def phase_train_extras(torch, rows, card, tmp):
    """Phase 6d: the training set and the training extras; its wavs stay
    in ``tmp`` for phase 6e."""
    from audiodenoiser_torch.ops.cuda import KERNELS, reset_launch_counts

    os.makedirs(tmp)
    reset_launch_counts()
    clean, noise = extras_native(torch, tmp)
    dataset = extras_dataset(torch, tmp, clean, noise, card)
    export = extras_train_clis(torch, tmp, dataset, clean)
    extras_ckpt_clis(torch, tmp, export)
    reset_launch_counts()
    extras_resume_fp32(torch, tmp)
    extras_remat_fp32(torch)
    extras_accum_fp32(torch)
    extras_mask(torch, tmp)
    launches = {k.__name__: k.launches for k in KERNELS}
    require_variants("phase 6d's in-process runs", {"stft_kernel": "fft",
                                                    "istft_kernel": "fft"})
    print(f"[6d launches] in-process training runs: {json.dumps(launches)}", flush=True)
    check(all(launches[k] > 0 for k in ("stft_kernel", "istft_kernel", "deconv_kernel")),
          "phase 6d did not run K1, K2 and K3")
    count_off_path(rows, "phase 6d")
    for name, n in launches.items():
        rows[name]["launches_6d"] = n
    extras_bench(torch, card)


GL_ITERS = 50
GL_TOL = {"reference": 1e-4, "correct": 1e-3}  # tests/test_torch_griffin_lim.py
# K1 and K2 launches of one specialist's test_single_noise_type (5 example
# clips): two Griffin-Lim calls of 50 iterations (K1 50, K2 51 each), two
# zero-phase iSTFTs for the magnitude-only SI-SDR, and the noisy-phase
# reconstruction's STFT and iSTFT
SPECIALIST_LAUNCHES = {"stft_kernel": {"fft": 2 * GL_ITERS + 1, "direct": 0},
                       "istft_kernel": {"fft": 2 * (GL_ITERS + 1) + 3, "direct": 0}}
# ... and of the universal mask model over one noise type at --n_seeds 2:
# per seed, the corruption's two STFTs, the runner's STFT and iSTFT, and the
# denoised clips' STFT
MASK_EVAL_LAUNCHES = {"stft_kernel": {"fft": 2 * 4, "direct": 0},
                      "istft_kernel": {"fft": 2 * 1, "direct": 0}}


def eval_istft_edges(torch, rng):
    """C.1 on the card: the plain iSTFT drops imaginary DC and Nyquist parts
    as irfft on the CPU does, and K2 agrees with it on the very spectrum it
    was given."""
    from audiodenoiser_torch.dsp.window import hann_window
    from audiodenoiser_torch.ops.cuda import istft_kernel, istft_plain

    for n_fft, hop in ((512, 128), (2048, 512)):
        shape = (16, n_fft // 2 + 1, 60)
        spec = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        zeroed = spec.copy()
        zeroed[:, [0, -1]] = zeroed[:, [0, -1]].real
        spec[:, [0, -1]] += 50j * rng.standard_normal((16, 2, 60))
        re, im = torch.view_as_real(torch.from_numpy(spec.astype("complex64")).cuda()).unbind(-1)
        re_z, im_z = torch.view_as_real(
            torch.from_numpy(zeroed.astype("complex64")).cuda()).unbind(-1)
        w = torch.from_numpy(hann_window(n_fft)).cuda()
        plain = istft_plain(re, im, w, n_fft, hop)
        plain_zeroed = istft_plain(re_z, im_z, w, n_fft, hop)
        kernel = istft_kernel(re, im, w, n_fft, hop)
        torch.cuda.synchronize()
        scale = plain_zeroed.abs().max().item()
        gap = (plain - plain_zeroed).abs().max().item() / scale
        err = (kernel - plain).abs().max().item() / plain.abs().max().item()
        print(f"[eval] C.1 n_fft={n_fft}: istft_plain with imaginary DC/Nyquist parts vs "
              f"zeroed max_rel_err={gap:.3e}; K2 vs istft_plain on that spectrum "
              f"max_rel_err={err:.3e}", flush=True)
        check(gap <= 1e-6, f"istft_plain used imaginary DC/Nyquist parts at n_fft {n_fft}")
        check(err <= 1e-5, f"K2 disagrees with istft_plain at n_fft {n_fft}")


def eval_griffin_lim(torch, card):
    """Griffin-Lim on the card (K1 and K2) against the CPU (plain versions),
    from one magnitude and one initial phase, at 1, 5 and 50 iterations;
    exact launch counts at 50; the time a call with either precision."""
    from audiodenoiser_torch.dsp.griffin_lim import griffin_lim, initial_phase
    from audiodenoiser_torch.dsp.stft import stft
    from audiodenoiser_torch.ops.cuda import istft_kernel, reset_launch_counts, stft_kernel
    from audiodenoiser_torch.data.synth import synth_chunks

    clips = synth_chunks(10, seed=6).reshape(5, -1)[:, : 3 * SR]  # 5 clips of 3 s
    mag = stft(torch.from_numpy(clips), N_FFT, HOP).abs()
    theta = initial_phase(mag.shape, torch.Generator().manual_seed(2))
    mag_d, theta_d = mag.cuda(), theta.cuda()
    for mode in ("reference", "correct"):
        errs = {}
        for n_iter in (1, 5, GL_ITERS):
            kw = dict(n_iter=n_iter, mode=mode, length=3 * SR, precision="kernel")
            reset_launch_counts()
            card_out = griffin_lim(mag_d, theta=theta_d, **kw)
            torch.cuda.synchronize()
            launches = {k.__name__: k.launches for k in (stft_kernel, istft_kernel)}
            check(launches == {"stft_kernel": n_iter, "istft_kernel": n_iter + 1},
                  f"Griffin-Lim ({mode}, {n_iter} iterations) launched {launches}")
            require_variants(f"Griffin-Lim ({mode}, {n_iter} iterations)",
                             {"stft_kernel": "fft", "istft_kernel": "fft"})
            cpu_out = griffin_lim(mag, theta=theta, **kw)
            card_out = card_out.cpu()
            check(bool(torch.isfinite(card_out).all()), "non-finite Griffin-Lim output")
            errs[n_iter] = ((card_out - cpu_out).norm() / cpu_out.norm()).item()
        print(f"[eval] Griffin-Lim {mode}, card (K1, K2) vs CPU (plain), rel_err by "
              f"iterations: {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}",
              flush=True)
        check(errs[GL_ITERS] < GL_TOL[mode], f"Griffin-Lim ({mode}) card vs CPU")
    times = {}
    for precision in ("kernel", "fft"):
        times[precision] = time_ms(lambda: griffin_lim(
            mag_d, theta=theta_d, n_iter=GL_ITERS, length=3 * SR, precision=precision),
            reps=10, warmup=2)
    print(f"[eval] Griffin-Lim, {GL_ITERS} iterations, 5 clips of 3 s, ms a call: "
          f"precision=kernel {times['kernel']:.3f}, precision=fft {times['fft']:.3f} "
          f"({card})", flush=True)


def _noise_wavs(path):
    """3 noise wavs of 1, 3 and 5 s: one tiled, one as long as a clip, one
    snipped at a random start."""
    import numpy as np

    from audiodenoiser_torch.data.wav_io import write_wav

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(7)
    for i, seconds in enumerate((1, 3, 5)):
        write_wav(os.path.join(path, f"noise_{i}.wav"),
                  np.clip(0.3 * rng.standard_normal(seconds * SR), -1, 1), SR)


def _start_cli(label, args, log_dir):
    """Start ``python -m <args>`` from the checkout, its output to a file,
    and a thread that notes the moment it exits."""
    env = {**os.environ, "PYTHONPATH": HERE}
    log = open(os.path.join(log_dir, f"{re.sub(r'[^a-z0-9]+', '_', label)}.log"), "w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=HERE, env=env,
                            stdout=log, stderr=subprocess.STDOUT, text=True)
    ended = []
    watcher = threading.Thread(target=lambda: ended.append((proc.wait(), time.perf_counter())),
                               daemon=True)
    watcher.start()
    return label, proc, log, t0, watcher, ended


def _finish_cli(started):
    """Wait for a started CLI: its output and wall seconds, start to exit;
    fails the run unless it exited 0 within 600 s."""
    label, proc, log, t0, watcher, ended = started
    watcher.join(timeout=600)
    check(bool(ended), f"{label} ran past 600 s")
    log.seek(0)
    out = log.read()
    for line in out.strip().splitlines()[-4:]:
        print(f"[{label}] {line}", flush=True)
    check(proc.returncode == 0, f"{label} exited {proc.returncode}")
    return out, ended[0][1] - t0


def _metrics_file_numbers(path):
    """Every number of a metrics file: ``name: value[ dB][ +- std]`` lines."""
    numbers = []
    for line in open(path).read().splitlines():
        m = re.match(r"^[^#].*?: (\S+)(?: dB)?(?: \+- (\S+))?$", line)
        if m:
            numbers += [float(x) for x in m.groups() if x is not None]
    return numbers


def eval_cli(tmp, mask_variables, card):
    """``cli.create_test_dataset`` and three ``cli.test`` runs, each in a
    subprocess on the card, over full-width seeded models the port exported."""
    clean_dir, noise_dir = os.path.join(tmp, "test", "clean"), os.path.join(tmp, "test", "noise")
    _write_wav_dir(clean_dir, 8, seconds=3.0)
    _noise_wavs(noise_dir)
    data = os.path.join(tmp, "test_processed")
    saved = _export_eval_models(tmp, mask_variables)
    # two at a time, to overlap each process's start (torch, CUDA): the
    # mask run reads the wavs and runs beside the test set's build, then
    # the two specialist runs read that set side by side
    cli_test = ["audiodenoiser_torch.cli.test", "--saved_models_dir", saved, "--test_data_dir",
                data, "--clean_dir", clean_dir, "--noise_dir", noise_dir]
    noise_types = ("white", "urban", "reverb", "noise_cancellation")
    runs = (("--model complex_mask --universal --n_seeds 2", noise_types, MASK_EVAL_LAUNCHES),
            ("--model unet --gl_mode reference_gl", ("white", "reverb"), SPECIALIST_LAUNCHES),
            ("--model unet --gl_mode griffin_lim", ("urban",), SPECIALIST_LAUNCHES))

    def start_test(i):
        label, types, _ = runs[i]
        return _start_cli(f"cli.test {label}", [
            *cli_test, "--output_dir", os.path.join(tmp, f"out_{i}"), *label.split(),
            "--noise_types", *types], tmp)

    create = _start_cli("create_test_dataset", [
        "audiodenoiser_torch.cli.create_test_dataset", "--clean_dir", clean_dir,
        "--noise_dir", noise_dir, "--output_dir", data], tmp)
    started = [create, start_test(0)]
    try:
        _, wall = _finish_cli(create)
        started += [start_test(1), start_test(2)]
        check_eval_runs(tmp, data, runs, started[1:], wall, card)
    finally:  # a failed check leaves no process running
        for _, proc, log, *_ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return saved


def check_eval_runs(tmp, data, runs, started, create_wall, card):
    """The test set's files, then each ``cli.test`` run's artifacts, metrics
    and launches."""
    import importlib.util

    import numpy as np

    noise_types = runs[0][1]
    frames = 1 + 3 * SR // HOP
    want = {"clean_audio.npy": (8, 3 * SR)}
    for nt in noise_types:
        want.update({f"clean_{nt}.npy": (8, N_FFT // 2 + 1, frames),
                     f"noisy_{nt}.npy": (8, N_FFT // 2 + 1, frames),
                     f"noisy_audio_{nt}.npy": (8, 3 * SR)})
    check(sorted(os.listdir(data)) == sorted(want), f"test set files {os.listdir(data)}")
    for name, shape in want.items():
        a = np.load(os.path.join(data, name))
        check(a.shape == shape and a.dtype == np.float32 and bool(np.isfinite(a).all()),
              f"{name}: {a.shape} {a.dtype}")
    print(f"[eval] cli.create_test_dataset wrote {len(want)} arrays of the expected names, "
          f"shapes and dtypes in {create_wall:.1f} s, beside the mask run ({card})", flush=True)

    plots = importlib.util.find_spec("matplotlib") is not None
    for i, (label, types, launches) in enumerate(runs):
        stdout, wall = _finish_cli(started[i])
        out_dir = os.path.join(tmp, f"out_{i}")
        seen = {m.group(1): json.loads(m.group(2))
                for m in re.finditer(r"^\[launches\] (\S+) (.*)$", stdout, re.M)}
        mask = "complex_mask" in label
        for nt in types:
            check(seen.get(nt) == launches,
                  f"cli.test {label}: {nt} launched {seen.get(nt)}, expected {launches}")
            names = [f"{nt}_metrics.txt"] + [f"{nt}_{kind}_{i}.wav" for i in range(5)
                                              for kind in ("noisy", "denoised")]
            if mask:
                names.append(f"{nt}_metrics_multiseed.txt")
            elif plots:
                names += [f"{nt}_spectrogram_{i}.png" for i in range(5)]
            missing = [n for n in names if not os.path.exists(os.path.join(out_dir, n))]
            check(not missing, f"cli.test {label} wrote no {missing}")
            for name in names:
                if name.endswith(".txt"):
                    numbers = _metrics_file_numbers(os.path.join(out_dir, name))
                    check(len(numbers) >= 4 and all(math.isfinite(x) for x in numbers),
                          f"cli.test {label}: {name} holds {numbers}")
        print(f"[eval] cli.test {label}: exit 0 in {wall:.1f} s, two runs at a time ({card}); "
              f"{len(os.listdir(out_dir))} artifacts, every metric finite"
              f"{'' if plots or mask else ' (no matplotlib: no PNGs)'}; launches a noise "
              f"type {json.dumps(launches)} as counted from the code", flush=True)


def _export_eval_models(tmp, mask_variables):
    """The full-width exports ``cli.test`` reads: one seeded magnitude U-Net
    as the white, urban and reverb specialists, and the mask deployment."""
    from audiodenoiser_torch.models import random_flax_variables
    from audiodenoiser_torch.train.checkpoints import export_model

    saved = os.path.join(tmp, "saved_models")
    os.makedirs(saved)
    unet = random_flax_variables(8)
    export_model(os.path.join(saved, "unet_denoiser_white.ckpt"), unet["params"],
                 unet["batch_stats"])
    for nt in ("urban", "reverb"):  # one set of weights for every specialist
        os.link(os.path.join(saved, "unet_denoiser_white.ckpt"),
                os.path.join(saved, f"unet_denoiser_{nt}.ckpt"))
    export_model(os.path.join(saved, "mask_denoiser_mixed.ckpt"), mask_variables["params"],
                 mask_variables["batch_stats"])
    with open(os.path.join(saved, "mask_denoiser_mixed.json"), "w") as f:
        json.dump({"width_mult": 1.0, "mask_bound": 2.0, "residual": True}, f)
    return saved


def eval_http(torch, rng, saved):
    """``cli.serve --model unet --mode griffin_lim``: one request in each
    Griffin-Lim mode, each against a direct runner call on the padded batch
    of one, which draws the same initial phase (the constant seed)."""
    import numpy as np

    from audiodenoiser_torch.cli.serve import build_server, parse_args
    from audiodenoiser_torch.data.wav_io import read_wav
    from audiodenoiser_torch.ops.cuda import istft_kernel, reset_launch_counts, stft_kernel

    service, server, name = build_server(parse_args([
        "--model", "unet", "--noise_type", "white", "--saved_models_dir", saved,
        "--mode", "griffin_lim", "--port", "0", "--max_seconds", "10"]))
    try:
        runner = service.runner
        check(name == "unet_denoiser_white" and service.default_mode == "griffin_lim"
              and runner.mode == "noisy_phase", "cli.serve built the wrong deployment")
        url = f"http://127.0.0.1:{server.server_address[1]}"
        threading.Thread(target=server.serve_forever, daemon=True).start()
        clip = np.clip(0.2 * rng.standard_normal(int(2.6 * SR)), -1, 1).astype(np.float32)
        sent = read_wav(io.BytesIO(_wav(clip)))[0]
        padded = np.zeros((1, service._bucket_len(len(sent))), np.float32)
        padded[0, : len(sent)] = sent
        for mode in ("griffin_lim", "reference_gl"):
            reset_launch_counts()
            answer = _post(url, _wav(clip), f"?mode={mode}")
            launches = {k.__name__: k.launches for k in (stft_kernel, istft_kernel)}
            check(launches == {"stft_kernel": 1 + GL_ITERS, "istft_kernel": GL_ITERS + 1},
                  f"?mode={mode} launched {launches}")
            require_variants(f"the ?mode={mode} request",
                             {"stft_kernel": "fft", "istft_kernel": "fft"})
            direct = runner.denoise_audio(torch.from_numpy(padded), mode=mode)[0, : len(sent)]
            check_answer(f"?mode={mode}", sent, answer, direct)
    finally:
        server.shutdown()
        server.server_close()


def phase_eval(torch, rng, mask_variables, card, tmp):
    """Phase 4c: the evaluation path on the card; its test set and wavs
    stay in ``tmp`` for phase 6e."""
    eval_istft_edges(torch, rng)
    eval_griffin_lim(torch, card)
    os.makedirs(tmp)
    t0 = time.perf_counter()
    saved = eval_cli(tmp, mask_variables, card)
    eval_http(torch, rng, saved)
    print(f"[eval] phase 4c's files, CLIs and requests in {time.perf_counter() - t0:.1f} s",
          flush=True)


ROUTER_PARAMS = 98_148
ROUTER_STEPS, ROUTER_BATCH = 300, 64
ROUTED_CLIPS = 256  # the routed bench's batch of mixed-corruption 2 s clips


def _routed_exports(saved):
    """Four seeded full-width specialists of each family, as ``cli.serve
    --auto_route`` and ``cli.test --auto_route`` read them; the mask ones
    with ``cli.train``'s per-type bounds (8 for noise_cancellation)."""
    from audiodenoiser_torch.models import NOISE_CLASSES, random_flax_variables
    from audiodenoiser_torch.train.checkpoints import export_model

    os.makedirs(saved)
    counts = set()
    for i, nt in enumerate(NOISE_CLASSES):
        for stem, chans in (("unet_denoiser", {}),
                            ("mask_denoiser", dict(in_channels=3, out_channels=2))):
            v = random_flax_variables(i, **chans)
            counts.add((stem, sum(a.size for a in _leaves(v["params"]).values())))
            path = os.path.join(saved, f"{stem}_{nt}.ckpt")
            export_model(path, v["params"], v["batch_stats"])
            if stem == "mask_denoiser":
                with open(os.path.splitext(path)[0] + ".json", "w") as f:
                    json.dump({"width_mult": 1.0, "residual": True,
                               "mask_bound": 8.0 if nt == "noise_cancellation" else 2.0}, f)
    check(counts == {("unet_denoiser", PARAMS_FULL), ("mask_denoiser", PARAMS_MASK)},
          f"specialists' parameter counts {counts}")


def _routed_clips(torch, n_each, seconds, seed, device="cpu"):
    """``4 * n_each`` speech-like clips, ``n_each`` corrupted each way
    (white and urban at 8 dB, reverb, noise cancellation on every block),
    in ``NOISE_CLASSES`` order, and their true labels."""
    import numpy as np

    from audiodenoiser_torch.dsp import noise as noise_lib
    from audiodenoiser_torch.data.synth import synth_chunks, synth_noise_clips

    n = int(seconds * SR)
    clean = torch.from_numpy(synth_chunks(4 * n_each, seed=seed)[:, :n]).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    clip = torch.from_numpy(synth_noise_clips(1, seed=seed)[0]).to(device)
    parts = clean.split(n_each)
    out = torch.cat([noise_lib.white(parts[0], 8.0, gen),
                     noise_lib.urban(parts[1], clip, 8.0, start=0),
                     noise_lib.reverb(parts[2]),
                     noise_lib.noise_cancellation(
                         parts[3], gate=torch.ones((n_each, -(-n // 16000)), dtype=torch.bool,
                                                   device=device))])
    return out, np.repeat(np.arange(4), n_each)


class _GatedClassifier:
    """Wraps a service's classifier: records each batch it scores and its
    labels; once ``close()`` is called, the next call holds the dispatcher
    (``holding`` set) until ``open()``, so that later requests coalesce."""

    def __init__(self, classify):
        self.classify = classify
        self.gate, self.holding = threading.Event(), threading.Event()
        self.gate.set()
        self.calls = []

    def close(self):
        self.gate.clear()

    def open(self):
        self.gate.set()

    def __call__(self, batch):
        if not self.gate.is_set():
            self.holding.set()
            self.gate.wait(timeout=60)
        labels = self.classify(batch)
        self.calls.append((batch.numpy().copy(), labels))
        return labels


def routed_router_cli(tmp, wavs, saved):
    """``cli.train --model router`` on phase 6d's wavs, in a subprocess."""
    return _start_cli("cli.train --model router", [
        "audiodenoiser_torch.cli.train", "--base_dataset_path", wavs, "--model", "router",
        "--pipeline", "on_device", "--noise_type", "mixed", "--batch_size", str(ROUTER_BATCH),
        "--epochs", "1", "--steps_per_epoch", str(ROUTER_STEPS), "--learning_rate", "1e-3",
        "--output_path", os.path.join(tmp, "router_runs"), "--export_dir", saved], tmp)


def routed_router_check(torch, started, saved):
    """The router CLI's held-out accuracy (> 0.5, as the JAX package's
    test requires), its export, sidecar and parameter count."""
    from audiodenoiser_torch.eval.ensemble import load_router
    from audiodenoiser_torch.models import count_params

    out, wall = _finish_cli(started)
    m = re.search(r"Router held-out accuracy: (\S+)", out)
    check(m is not None, "cli.train --model router printed no held-out accuracy")
    acc = float(m.group(1))
    path = os.path.join(saved, "noise_router.ckpt")
    check(os.path.exists(path), "cli.train --model router exported no noise_router.ckpt")
    with open(os.path.join(saved, "noise_router.json")) as f:
        sidecar = json.load(f)
    router, window = load_router(path)
    n = count_params(router)
    print(f"[routed] cli.train --model router: {ROUTER_STEPS} steps of {ROUTER_BATCH} in "
          f"{wall:.1f} s with the process's start, held-out accuracy {acc:.3f}, "
          f"{n:,} parameters, sidecar {sidecar}", flush=True)
    check(acc > 0.5, f"router held-out accuracy {acc} not above 0.5")
    check(n == ROUTER_PARAMS and sidecar == {"window": [256, 64]} and window == (256, 64),
          "the router's export")


def routed_serve(torch, rows, saved):
    """``cli.serve --auto_route``: 8 ``/denoise?mode=auto`` requests (the
    first alone, seven coalesced behind it), each against its predicted
    expert's runner on the padded group the service formed, K1 and K2
    counted; one ``?mode=auto`` stream; a reload to generation 1."""
    import numpy as np

    from audiodenoiser_torch.data.wav_io import read_wav
    from audiodenoiser_torch.eval.streaming import RoutedStreamingSession
    from audiodenoiser_torch.ops.cuda import istft_kernel, reset_launch_counts, stft_kernel

    t0 = time.perf_counter()
    service, server, url = _serve(["--auto_route", "--saved_models_dir", saved, "--port", "0",
                                   "--max_seconds", "10"])
    try:
        mix = server.current_generation()["mixture"]
        print(f"[routed] cli.serve --auto_route built and warmed up in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(service.default_mode == "auto" and len(service.expert_runners) == 4
              and mix.family == "magnitude", "cli.serve --auto_route built the wrong deployment")
        noisy, truth = _routed_clips(torch, 2, 2.0, seed=21)
        lengths = [16000, 12000, 15000, 9000, 16000, 13000, 11000, 14000]
        clips = [noisy[i, :n].numpy() for i, n in enumerate(lengths)]
        sent = [read_wav(io.BytesIO(_wav(c)))[0] for c in clips]
        gated = _GatedClassifier(service._auto[0])
        service._auto = (gated, service._auto[1])
        answers = {}

        def post(i):
            answers[i] = _post(url, _wav(clips[i]), "?mode=auto")

        reset_launch_counts()
        gated.close()
        threads = [threading.Thread(target=post, args=(0,))]
        threads[0].start()
        check(gated.holding.wait(timeout=60), "the first routed request never dispatched")
        for i in range(1, 8):
            threads.append(threading.Thread(target=post, args=(i,)))
            threads[-1].start()
        deadline = time.monotonic() + 30
        while "adt_queue_depth 7" not in service.metrics_text():
            check(time.monotonic() < deadline, "the 7 routed requests never queued")
            time.sleep(0.01)
        gated.open()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), "a routed request never finished")
        launches = {k.__name__: k.launches for k in (stft_kernel, istft_kernel)}
        groups = [len(set(labels[: len(np.nonzero(batch.any(axis=1))[0])].tolist()))
                  for batch, labels in gated.calls]
        print(f"[routed] 8 requests in {len(gated.calls)} batches, router labels "
              f"{[labels.tolist() for _, labels in gated.calls]} (true {truth.tolist()}), "
              f"{sum(groups)} expert groups, launches {launches}", flush=True)
        check(len(gated.calls) == 2, "the seven routed requests did not coalesce")
        check(launches == {"stft_kernel": len(gated.calls) + sum(groups),
                           "istft_kernel": sum(groups)},
              "K1 != classify calls + expert groups or K2 != expert groups")
        _stream_kernels(rows, "the routed requests")
        for name, n in launches.items():
            rows[name]["launches"] += n
            rows[name]["launches_routed"] = n
        # each answer against its expert on the group the service formed
        for i, clip in enumerate(sent):
            (batch, labels), row = next(
                ((b, lab), r) for b, lab in gated.calls for r in range(len(b))
                if np.array_equal(b[r, : len(clip)], clip) and not b[r, len(clip):].any())
            real = len(np.nonzero(batch.any(axis=1))[0])
            idx = [r for r in range(real) if labels[r] == labels[row]]
            sub = np.zeros((1 << (len(idx) - 1).bit_length(), batch.shape[1]), np.float32)
            sub[: len(idx)] = batch[idx]
            direct = service.expert_runners[int(labels[row])].denoise_audio(
                torch.from_numpy(sub))[idx.index(row), : len(clip)]
            check_answer(f"auto {i} ({int(labels[row])} of {len(idx)})", clip, answers[i], direct)
        # a routed stream: as many samples out as in, as a direct session
        signal = noisy[:3].reshape(-1)[: 6 * SR].numpy()
        packets = _ragged(len(signal), 6)
        info = _start(url, "?mode=auto")
        out = _feed(url, info["session"], signal, packets)
        direct = RoutedStreamingSession(mix, chunk_samples=2 * SR)
        ref = _session_out(direct, signal, packets)
        print(f"[routed] /stream/start?mode=auto: latency_samples {info['latency_samples']}, "
              f"{len(out)} of {len(signal)} samples out, chosen {direct.chosen!r}, switches "
              f"{direct.switches}, rel_err vs a direct session {_rel(out, ref):.3e}", flush=True)
        check(info["latency_samples"] == 4 * SR and len(out) == len(signal)
              and bool(np.isfinite(out).all()), "the routed stream")
        check(_rel(out, ref) < SERVE_TOL, "the routed stream disagrees with a direct session")
        # reload: generation 1 serves the next mode=auto request
        t0 = time.perf_counter()
        code, body = _http_code(url, "/admin/reload")
        new = server.current_generation()["mixture"]
        print(f"[routed] /admin/reload: {code} {body} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        check(code == 200 and json.loads(body)["generation"] == 1 and service.generation == 1
              and new is not mix, "the routed reload")
        answer = _post(url, _wav(clips[2]), "?mode=auto")
        padded = torch.from_numpy(np.pad(sent[2], (0, 2 * SR - len(sent[2])))[None])
        label = int(new.classify_waveform(padded)[0])
        check_answer("auto after reload", sent[2], answer,
                     new.runners[label].denoise_audio(padded)[0, : len(sent[2])])
    finally:
        server.shutdown()
        server.server_close()


def routed_fp32(torch, saved):
    """fp32 card (K1, K2, cuDNN without TF32) against the CPU (plain):
    the router's logits on 8 clips, a routed ``denoise_waveform`` with the
    same labels, and a routed stream whose corruption changes halfway."""
    import numpy as np

    from audiodenoiser_torch.dsp import noise as noise_lib
    from audiodenoiser_torch.dsp.stft import stft
    from audiodenoiser_torch.eval.ensemble import load_mixture
    from audiodenoiser_torch.eval.streaming import RoutedStreamingSession
    from audiodenoiser_torch.data.synth import synth_chunks

    noisy, _ = _routed_clips(torch, 2, 2.0, seed=22)
    # 5 s of white noise, then 5 s of reverb, re-routed every chunk of 1 s
    speech = torch.from_numpy(synth_chunks(6, seed=24).reshape(2, -1)[:, : 5 * SR])
    signal = torch.cat([noise_lib.white(speech[:1], 8.0, torch.Generator().manual_seed(5))[0],
                        noise_lib.reverb(speech[1:])[0]]).numpy()
    packets = _ragged(len(signal), 9)
    out, sessions = {}, {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for d in ("cuda", "cpu"):
            mix = load_mixture(saved, dtype=torch.float32, device=d, router_dtype=torch.float32)
            x = noisy.to(d)
            mag = stft(x, N_FFT, HOP, precision=mix.precision).abs()
            sessions[d] = RoutedStreamingSession(mix, chunk_samples=SR, reclassify_every=1)
            out[d] = {"logits": mix.logits(mag[:, None]).cpu(),
                      "wave": mix.denoise_waveform(x[:4], labels=np.arange(4)).cpu(),
                      "stream": _session_out(sessions[d], signal, packets)}
    err = ((out["cuda"]["logits"] - out["cpu"]["logits"]).abs().max()
           / out["cpu"]["logits"].abs().max()).item()
    rel = _rel(out["cuda"]["wave"], out["cpu"]["wave"])
    print(f"[routed fp32] router logits of 8 clips card vs CPU: max|d|/max|CPU| {err:.3e}; "
          f"denoise_waveform through the four experts (labels 0-3): rel_err {rel:.3e}",
          flush=True)
    check(err <= 1e-5, "the router's fp32 logits card vs CPU")
    check(rel < SLICE_TOL, "routed denoise_waveform fp32 card vs CPU")
    card, cpu = sessions["cuda"], sessions["cpu"]
    rel = _rel(out["cuda"]["stream"], out["cpu"]["stream"])
    print(f"[routed fp32] stream white -> reverb, re-routed every 1 s chunk: "
          f"{len(out['cuda']['stream'])} of {len(signal)} samples, chosen {card.chosen!r} / "
          f"{cpu.chosen!r}, switches card {card.switches} CPU {cpu.switches}, "
          f"rel_err {rel:.3e}", flush=True)
    check(len(out["cuda"]["stream"]) == len(signal) and rel < SLICE_TOL,
          "routed stream fp32 card vs CPU")
    check(card.switches == cpu.switches and card.chosen == cpu.chosen,
          "the routed streams switched differently on the card and the CPU")


def routed_eval_start(tmp, eval_dir, saved):
    """``cli.test --auto_route`` for both families, two subprocesses."""
    base = ["audiodenoiser_torch.cli.test", "--auto_route", "--saved_models_dir", saved]
    return [_start_cli("cli.test --auto_route", base + [
                "--test_data_dir", os.path.join(eval_dir, "test_processed"),
                "--output_dir", os.path.join(tmp, "routed_unet")], tmp),
            _start_cli("cli.test --auto_route --model complex_mask", base + [
                "--model", "complex_mask", "--clean_dir", os.path.join(eval_dir, "test", "clean"),
                "--noise_dir", os.path.join(eval_dir, "test", "noise"),
                "--output_dir", os.path.join(tmp, "routed_mask")], tmp)]


def routed_eval_check(tmp, started, card):
    from audiodenoiser_torch.models import NOISE_CLASSES

    for run, out_dir in zip(started, ("routed_unet", "routed_mask")):
        stdout, wall = _finish_cli(run)
        acc = {}
        for nt in NOISE_CLASSES:
            path = os.path.join(tmp, out_dir, f"{nt}_routed_metrics.txt")
            check(os.path.exists(path), f"{run[0]} wrote no {nt}_routed_metrics.txt")
            lines = [l for l in open(path).read().splitlines()[1:] if not l.startswith("#")]
            numbers = [float(l.split(": ")[1].split()[0]) for l in lines]
            check(len(numbers) >= 5 and all(math.isfinite(x) for x in numbers),
                  f"{run[0]}: {nt}'s metrics {numbers}")
            acc[nt] = numbers[0]
        launches = re.findall(r"^\[launches\] auto_route (.*)$", stdout, re.M)
        # one process is fewer than four ranks: --ep auto takes the bucketed dispatch
        ep = "Expert-parallel mesh" in stdout
        print(f"[routed] {run[0]}: exit 0 in {wall:.1f} s ({card}); routing accuracy "
              f"{json.dumps(acc)}; launches {launches[0] if launches else None}; expert "
              f"mesh {ep}", flush=True)
        check(len(launches) == 1 and not ep, f"{run[0]}: [launches] lines {len(launches)}, "
              f"expert mesh {ep}")


def routed_bench(torch, saved, card):
    """The router's forward at 256 windows of (256, 64), and a routed batch
    of 256 mixed-corruption 2 s clips through the four folded bf16
    experts against one expert on the whole batch, in CUDA events."""
    import numpy as np

    from audiodenoiser_torch.eval.ensemble import load_mixture

    mix = load_mixture(saved)  # bf16 experts and router, folded, K1/K2
    x = torch.rand((256, 1, 256, 64), device="cuda") * 3
    with torch.inference_mode():
        router_ms = time_ms(lambda: mix.router(x), reps=20)
    wavs, truth = _routed_clips(torch, ROUTED_CLIPS // 4, 2.0, seed=25, device="cuda")
    labels = mix.classify_waveform(wavs).cpu().numpy()
    counts = np.bincount(labels, minlength=4).tolist()
    padded = [1 << (n - 1).bit_length() if n else 0 for n in counts]
    classify_ms = time_ms(lambda: mix.classify_waveform(wavs), reps=10)
    denoise_ms = time_ms(lambda: mix.denoise_waveform(wavs, labels=labels), reps=5, warmup=2)
    routed_ms = time_ms(lambda: mix.denoise_waveform(wavs), reps=5, warmup=2)
    single_ms = time_ms(lambda: mix.runners[0].denoise_audio(wavs), reps=5, warmup=2)
    frames = ROUTED_CLIPS * (1 + 2 * SR // HOP)
    line = {"metric": "routed_frames_per_s", "value": frames / routed_ms * 1e3,
            "single_model_frames_per_s": frames / single_ms * 1e3,
            "routed_ms": routed_ms, "classify_ms": classify_ms, "denoise_ms": denoise_ms,
            "single_model_ms": single_ms, "router_ms_256_windows": router_ms,
            "group_sizes": counts, "padded_rows": sum(padded),
            "routing_accuracy": float(np.mean(labels == truth)), "card": card}
    print(f"[routed bench] {json.dumps(line)}", flush=True)
    check(line["value"] > 0 and sum(counts) == ROUTED_CLIPS, "the routed bench")


def phase_routed(torch, rows, card, eval_dir, wavs):
    """Phase 6e: the self-routing deployment at full width."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_6e_")
    saved = os.path.join(tmp, "saved_models")
    started = []
    try:
        t0 = time.perf_counter()
        _routed_exports(saved)
        print(f"[routed] 8 full-width specialists written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        started.append(routed_router_cli(tmp, wavs, saved))
        routed_router_check(torch, started[0], saved)
        started += routed_eval_start(tmp, eval_dir, saved)
        routed_serve(torch, rows, saved)
        count_off_path(rows, "phase 6e")
        routed_fp32(torch, saved)
        routed_eval_check(tmp, started[1:], card)
        routed_bench(torch, saved, card)
    finally:  # a failed check leaves no process running
        for _, proc, log, *_ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


PARAMS_STUDENT = 1_944_066  # the width-0.25 ComplexMaskUNet (README's compact student)
STUDENT_WIDTH = 0.25
STUDENT_STEPS, STUDENT_VAL, STUDENT_BATCH = 8, 2, 16  # phase 6f's in-process fit


def _student_sidecar(teacher):
    """``cli.train``'s sidecar for the distilled mixed student, JAX's keys."""
    return {**MASK_SIDECAR, "width_mult": STUDENT_WIDTH, "distilled_from": teacher,
            "distill_features": 1.0}


def student_teacher(tmp):
    """Phase 6f (a): a seeded full-width residual mask teacher (bound 8)
    exported with its sidecar; returns its path and variables."""
    from audiodenoiser_torch.models import random_flax_variables
    from audiodenoiser_torch.train.checkpoints import export_model

    variables = random_flax_variables(11, in_channels=3, out_channels=2)
    path = os.path.join(tmp, "teacher", "mask_denoiser_mixed.ckpt")
    export_model(path, variables["params"], variables["batch_stats"])
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump({"width_mult": 1.0, "mask_bound": 8.0, "residual": True}, f)
    return path, variables


def student_cli_start(tmp, wavs, teacher):
    """Phase 6f (b), started: the distilled, quantized student through
    ``cli.train`` on phase 6d's wavs, in a subprocess."""
    export = os.path.join(tmp, "student_saved")
    return export, _start_cli("cli.train student", [
        "audiodenoiser_torch.cli.train", "--base_dataset_path", wavs, "--pipeline", "on_device",
        "--model", "complex_mask", "--noise_type", "mixed", "--width_mult", str(STUDENT_WIDTH),
        "--distill_from", teacher, "--distill_features", "1.0", "--epochs", "1",
        "--steps_per_epoch", "4", "--output_path", os.path.join(tmp, "student_runs"),
        "--export_dir", export, "--export_quantized"], tmp)


def student_cli_check(torch, started, export, teacher):
    """Phase 6f (b): the export is int8-v1 with JAX's sidecar keys, and the
    student it holds has 1,944,066 parameters."""
    from audiodenoiser_torch.eval.runner import load_model_from_path
    from audiodenoiser_torch.models import count_params
    from audiodenoiser_torch.train import msgpack_codec
    from audiodenoiser_torch.train.checkpoints import INT8_FORMAT

    out, wall = _finish_cli(started)
    path = os.path.join(export, "mask_denoiser_mixed.ckpt")
    with open(os.path.splitext(path)[0] + ".json") as f:
        meta = json.load(f)
    with open(path, "rb") as f:
        fmt = msgpack_codec.restore(f.read()).get("format")
    model = load_model_from_path(path, dtype=torch.float32, device="cpu", fold=False)
    n = count_params(model)
    print(f"[6f] cli.train student: exit 0 in {wall:.1f} s with the process's start; "
          f"{n} parameters, {os.path.getsize(path)} byte {fmt} export, sidecar {meta}",
          flush=True)
    check(n == PARAMS_STUDENT, f"the student has {n} parameters, not {PARAMS_STUDENT}")
    check(fmt == INT8_FORMAT, f"--export_quantized wrote format {fmt}")
    check(meta == _student_sidecar(teacher), f"the student's sidecar {meta}")


def _distilled_step(torch, s_vars, t_vars, noisy, clean, dev):
    """One fp32 distilled step of the width-0.25 student (K3) against the
    full-width teacher on ``dev``: its losses and updated weights by name."""
    from audiodenoiser_torch.models import ComplexMaskUNet, state_dict_from_flax, width_kwargs
    from audiodenoiser_torch.train.mask import create_mask_train_state, make_mask_steps

    teacher = ComplexMaskUNet(mask_bound=8.0, residual=True)
    teacher.load_state_dict(state_dict_from_flax(t_vars))
    teacher = teacher.to(dev).eval().requires_grad_(False)
    model = ComplexMaskUNet(**width_kwargs(STUDENT_WIDTH), mask_bound=8.0, residual=True,
                            pallas_deconv=True)
    state = create_mask_train_state(0, model, variables=s_vars, device=dev)
    step = make_mask_steps(0.5, 30.0, teacher=teacher, distill_weight=0.5,
                           distill_feat_weight=1.0)[0]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        state, losses = step(state, noisy.to(dev), clean.to(dev))
    return ([float(x) for x in losses],
            {n: p.detach().cpu() for n, p in model.named_parameters()})


def student_step_fp32(torch, t_vars):
    """Phase 6f (c): one fp32 distilled step, card (K1, K2 and its
    gradient, K3) against CPU (plain versions), from one student tree, the
    teacher of (a) and one batch of the mixed mixer: losses and weights
    within 1e-4 relative L2 (the conv biases that feed a train-mode
    BatchNorm, whose gradient is rounding alone, printed apart)."""
    from audiodenoiser_torch.models import (
        random_flax_variables,
        state_dict_from_flax,
        width_kwargs,
    )
    from audiodenoiser_torch.ops.cuda import (
        deconv_kernel,
        istft_kernel,
        reset_launch_counts,
        stft_kernel,
    )

    s_vars = random_flax_variables(12, **width_kwargs(STUDENT_WIDTH), in_channels=3,
                                   out_channels=2)
    noisy, clean = _mask_mixer(torch, 8, 4, "cpu").sample_audio(
        torch.Generator().manual_seed(6), 2)
    got = {}
    for dev in ("cuda", "cpu"):
        reset_launch_counts()
        t0 = time.perf_counter()
        got[dev] = _distilled_step(torch, s_vars, t_vars, noisy, clean, dev)
        if dev == "cuda":
            counts = (stft_kernel.launches, istft_kernel.launches, deconv_kernel.launches)
            check(counts == (2, 1, 4), f"the fp32 distilled step launched K1, K2, K3 {counts}")
        print(f"[6f fp32] distilled step on {dev} in {time.perf_counter() - t0:.2f} s",
              flush=True)
    (lc, wc), (lp, wp) = got["cuda"], got["cpu"]
    start = state_dict_from_flax(s_vars)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    held = [n for n in wp if not n.endswith(BN_FED_BIASES)]
    weights = _rel_l2(torch.cat([wc[n].flatten() for n in held]),
                      torch.cat([wp[n].flatten() for n in held]))
    steps = _rel_l2(torch.cat([(wc[n] - start[n]).flatten() for n in held]),
                    torch.cat([(wp[n] - start[n]).flatten() for n in held]))
    by_name = {n: _rel_l2(wc[n], wp[n]) for n in wp}
    fed = {n: e for n, e in by_name.items() if n.endswith(BN_FED_BIASES)}
    print(f"[6f fp32] width 0.25 student + full-width teacher, card vs CPU: losses "
          f"{[round(x, 6) for x in lc]} vs {[round(x, 6) for x in lp]} (max rel "
          f"{loss_err:.3e}); updated weights rel L2 {weights:.3e} over all, worst "
          f"{_worst({n: by_name[n] for n in held})}; the AdamW steps themselves rel L2 "
          f"{steps:.3e}; BN-fed conv biases, printed apart: worst {_worst(fed, 2)}", flush=True)
    check(all(math.isfinite(x) for x in lc) and loss_err <= TRAIN_TOL,
          "fp32 distilled step: the losses, card vs CPU")
    check(weights <= TRAIN_TOL, "fp32 distilled step: the updated weights, card vs CPU")


def _student_state(torch, dtype):
    from audiodenoiser_torch.models import ComplexMaskUNet, width_kwargs
    from audiodenoiser_torch.train.mask import create_mask_train_state

    return create_mask_train_state(0, ComplexMaskUNet(
        **width_kwargs(STUDENT_WIDTH), dtype=dtype, pallas_deconv=True, mask_bound=8.0,
        residual=True, zero_out_init=True))


def student_fit(torch, rows, tmp, teacher_path, card):
    """Phase 6f (d): ``fit`` of the bf16 width-0.25 student with K3 against
    the bf16 live-BN teacher on the mixed mixer: K1 2 launches a train step
    and 1 a validation step, K2 1 a step, K3 4 a student forward (the
    teacher's upsamplings are cuDNN's), K4 0; then the ms a step with and
    without the teacher and each one's peak memory."""
    from audiodenoiser_torch.eval.runner import load_model_from_path
    from audiodenoiser_torch.ops.cuda import (
        deconv_kernel,
        istft_kernel,
        reset_launch_counts,
        stft_kernel,
    )
    from audiodenoiser_torch.eval.bench import device_breakdown
    from audiodenoiser_torch.train.loop import FitConfig, fit
    from audiodenoiser_torch.train.mask import make_mask_steps
    from audiodenoiser_torch.utils import profiling

    teacher = load_model_from_path(teacher_path, dtype=torch.bfloat16,
                                   fold=False).requires_grad_(False)
    distilled = make_mask_steps(0.5, 30.0, teacher=teacher, distill_weight=0.5,
                                distill_feat_weight=1.0)
    mixer, val_mixer = _mask_mixer(torch, 64, 7, "cuda"), _mask_mixer(torch, 8, 9, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = FitConfig(run_name="student", output_path=os.path.join(tmp, "student_fit"), epochs=1,
                    batch_size=STUDENT_BATCH, precision="bf16", log_every=0)
    batch = STUDENT_BATCH
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fit(cfg, lambda e: (mixer.sample_audio(gen, batch) for _ in range(STUDENT_STEPS)),
              lambda: (val_mixer.sample_audio(gen, batch) for _ in range(STUDENT_VAL)),
              state_factory=lambda: _student_state(torch, torch.bfloat16), steps=distilled)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = (stft_kernel.launches, istft_kernel.launches, deconv_kernel.launches)
    forwards = STUDENT_STEPS + STUDENT_VAL
    want = (2 * STUDENT_STEPS + STUDENT_VAL, forwards, 4 * forwards)
    print(f"[6f fit] {STUDENT_STEPS} distilled steps + {STUDENT_VAL} validation at batch "
          f"{batch} in {fit_s:.2f} s (set-up and export included); history "
          f"{res['history']}; launches K1={counts[0]} K2={counts[1]} K3={counts[2]}, "
          f"expected {want}", flush=True)
    check(all(math.isfinite(v) for v in res["history"][0].values()), "the student's fit")
    check(counts == want, "the distilled fit's K1/K2/K3 launches")
    seen = require_variants("the distilled fit", {"stft_kernel": "fft", "istft_kernel": "fft",
                                                  "deconv_kernel": "wgmma"})
    count_off_path(rows, "the distilled fit")
    check(not any(m._forward_hooks for m in res["state"].model.modules())
          and not any(m._forward_hooks for m in teacher.modules()),
          "a feature tap outlived the fit")
    launches = dict(zip(("stft_kernel", "istft_kernel", "deconv_kernel"), counts))

    timed = {}
    for label, steps in (("with_teacher", distilled), ("without_teacher",
                                                       make_mask_steps(0.5, 30.0))):
        state = _student_state(torch, torch.bfloat16)

        def step():
            return steps[0](state, *mixer.sample_audio(gen, batch))[1]

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = profiling.timed(step, warmup=0, iters=10)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = device_breakdown(step, 3, torch.device("cuda"))
        timed[label] = {"step_ms": r["mean_s"] * 1e3, "samples_per_sec": batch / r["mean_s"],
                        "peak_memory_gib": peak, "device_busy_ms": prof["device_busy_ms"],
                        "idle_share": prof.get("idle_share", "not measured")}
        del state
        torch.cuda.empty_cache()
    print(f"[6f fit] bf16 batch {batch}, 10 steps after 3, profile of 3: {json.dumps(timed)}; "
          f"{card}", flush=True)
    return launches, seen


def _serve_mask_export(torch, rng, rows, export, tag, built_right):
    """``cli.serve --model complex_mask --noise_type mixed`` over the export
    in ``export`` (its sidecar rebuilds the model, folded to bf16): 5
    ``/denoise`` requests, each against a direct call on the batch the
    service formed, and one ``/stream`` session as long out as in; returns
    K1's and K2's launches. ``built_right(model)`` checks what it built."""
    import numpy as np

    from audiodenoiser_torch.data.wav_io import read_wav
    from audiodenoiser_torch.ops.cuda import istft_kernel, reset_launch_counts, stft_kernel

    service, server, url = _serve(["--model", "complex_mask", "--noise_type", "mixed",
                                   "--saved_models_dir", export, "--port", "0",
                                   "--max_seconds", "10"])
    try:
        runner = service.runner
        check(built_right(runner.model) and runner.device.type == "cuda",
              f"[{tag}] cli.serve built the wrong model")
        clips = [_signal(rng, int(round(s * SR))) for s in (0.5, 1.3, 2.0, 2.7, 3.1)]
        signal = _signal(rng, 3 * SR)
        reset_launch_counts()
        t0 = time.perf_counter()
        answers = [_post(url, _wav(c), "?mode=complex_mask") for c in clips]
        info = _start(url)
        out = _feed(url, info["session"], signal, (1000, 4000, 7000, 12000))
        serve_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in (stft_kernel, istft_kernel)}
        print(f"[{tag}] folded to bf16 (widths {runner.model.features} from its sidecar): "
              f"5 requests and a 3 s stream in {serve_s:.3f} s, stream {len(out)} of "
              f"{len(signal)} samples, launches {launches}", flush=True)
        check(len(out) == len(signal) and bool(np.isfinite(out).all()),
              f"[{tag}] the stream did not return as many samples as it was fed")
        _stream_kernels(rows, f"[{tag}] requests and stream")
        for clip, answer in zip(clips, answers):
            sent = read_wav(io.BytesIO(_wav(clip)))[0]
            padded = np.zeros((1, service._bucket_len(len(sent))), np.float32)
            padded[0, : len(sent)] = sent
            direct = runner.denoise_audio(torch.from_numpy(padded))[0, : len(sent)]
            check_answer(f"{tag} {len(clip) / SR:.1f} s", sent, answer, direct)
    finally:
        server.shutdown()
        server.server_close()
    return launches


def student_serve(torch, rng, rows, export):
    """Phase 6f (e): the int8 student export served by ``cli.serve --model
    complex_mask --noise_type mixed`` (width from its sidecar, folded to
    bf16): 5 ``/denoise`` requests, each against a direct call on the batch
    the service formed, and one ``/stream`` session as long out as in."""
    return _serve_mask_export(torch, rng, rows, export, "6f serve", lambda m: (
        m.features == (16, 32, 64, 128) and m.mask_bound == 8.0 and m.mask_residual))


def student_bench(torch, card):
    """Phase 6f (f): the student's serving benches at batch 256 (folded, in
    both modes, and live-BN with K3), and the training leg of
    ``eval.bench`` (full width, fixed crops) at batch 256 and 16, each with
    its device idle share and peak memory."""
    from audiodenoiser_torch.eval.bench import run_bench, run_train_bench
    from audiodenoiser_torch.ops.cuda import deconv_kernel, reset_launch_counts

    out = {}
    for label, kw in (("noisy_phase", {}), ("complex_mask", {"mode": "complex_mask"}),
                      ("pallas_deconv", {"pallas_deconv": True})):
        reset_launch_counts()
        r = run_bench(batch_size=256, clip_seconds=2.0, iters=10, profile_iters=3,
                      width_mult=STUDENT_WIDTH, **kw)
        expect = {"stft_kernel": "fft", "istft_kernel": "fft"}
        if kw.get("pallas_deconv"):
            expect["deconv_kernel"] = "wgmma"
            check(deconv_kernel.launches == 4 * (3 + 10 + 3), "the student K3 bench's launches")
        require_variants(f"the student's {label} bench", expect)
        prof = r.pop("profile")
        out[label] = {"frames_per_sec": r["value"], "batch_ms": r["batch_ms"],
                      "device_busy_ms": prof["device_busy_ms"],
                      "idle_share": prof.get("idle_share", "not measured")}
        print(f"[6f bench] student {label}: {json.dumps(r)}; profile "
              f"{json.dumps({k: v for k, v in prof.items() if k != 'top'})}", flush=True)
        for row in prof.get("top", [])[:6]:
            print(f"[6f bench] student {label} profile: {row['ms']:.4f} ms {row['share']:.3f} "
                  f"{row['kernel']}", flush=True)
        check(r["value"] > 0, f"the student's {label} bench measured nothing")
    for batch in (256, 16):
        torch.cuda.empty_cache()
        r = run_train_bench(batch, profile_iters=3)
        out[f"train_b{batch}"] = r
        print(f"[6f train leg] batch {batch}: {json.dumps(r)}; {card}", flush=True)
        check(math.isfinite(r["train_last_loss"]) and r["train_samples_per_sec"] > 0,
              f"the training leg at batch {batch}")
    return out


def phase_student(torch, rng, rows, card, wavs):
    """Phase 6f: the compact distilled student at width 0.25."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_6f_")
    started = None
    try:
        teacher, t_vars = student_teacher(tmp)
        export, started = student_cli_start(tmp, wavs, teacher)
        student_step_fp32(torch, t_vars)
        fit_launches, seen = student_fit(torch, rows, tmp, teacher, card)
        student_cli_check(torch, started, export, teacher)
        serve_launches = student_serve(torch, rng, rows, export)
        for name, n in fit_launches.items():
            n += serve_launches.get(name, 0)
            rows[name]["launches"] += n
            rows[name]["launches_student"] = n
        rows["deconv_kernel"]["student_variant_launches"] = seen["deconv_kernel"]
        return student_bench(torch, card)
    finally:
        if started is not None and started[1].poll() is None:  # a check failed first
            started[1].kill()
            started[1].wait()
        shutil.rmtree(tmp, ignore_errors=True)


PARAMS_S2D_SKIP = 31_048_641  # UNet(s2d_stem, s2d_skip=16), JAX's eval_shape count
PARAMS_MENU_MASK = 32_106_242  # ComplexMaskUNet(s2d_stem, s2d_skip=16, attn_bottleneck)
MENU = {"s2d_stem": True, "s2d_skip": 16, "attn_bottleneck": True}
MENU_STEPS = 4  # the variant cli.train's and fit's steps (and 1 validation step)


def menu_cli_start(tmp, wavs):
    """Phase 6g (c), started: ``cli.train --model complex_mask --s2d_stem
    --s2d_skip 16 --attn_bottleneck`` in bf16 on phase 6d's wavs, in a
    subprocess."""
    export = os.path.join(tmp, "menu_saved")
    return export, _start_cli("cli.train menu", [
        "audiodenoiser_torch.cli.train", "--base_dataset_path", wavs, "--pipeline", "on_device",
        "--model", "complex_mask", "--noise_type", "mixed", "--s2d_stem", "--s2d_skip", "16",
        "--attn_bottleneck", "--epochs", "1",
        "--steps_per_epoch", str(MENU_STEPS), "--output_path", os.path.join(tmp, "menu_runs"),
        "--export_dir", export], tmp)


def menu_cli_check(torch, started, export):
    """Phase 6g (c): the run's ``[launches]`` line (K1 2 a train step and
    1 a validation step, K2 1 a step, through their FFT entries; K3 and K4
    0, the upsamplings being cuDNN's as in JAX's CLI), its export of
    32,106,242 parameters and its sidecar's keys."""
    from audiodenoiser_torch.eval.runner import load_model_from_path
    from audiodenoiser_torch.models import count_params

    out, wall = _finish_cli(started)
    lines = [ln for ln in out.splitlines() if ln.startswith("[launches] ")]
    check(len(lines) == 1, "the variant cli.train printed no [launches] line")
    counts = json.loads(lines[0][len("[launches] "):])
    forwards = MENU_STEPS + 1
    got = (counts["stft_kernel"]["launches"], counts["istft_kernel"]["launches"],
           counts["deconv_kernel"]["launches"], counts["overlap_add_kernel"]["launches"])
    want = (2 * MENU_STEPS + 1, forwards, 0, 0)
    path = os.path.join(export, "mask_denoiser_mixed.ckpt")
    with open(os.path.splitext(path)[0] + ".json") as f:
        meta = json.load(f)
    model = load_model_from_path(path, dtype=torch.float32, device="cpu", fold=False)
    n = count_params(model)
    print(f"[6g cli.train] exit 0 in {wall:.1f} s with the process's start; launches {counts}, "
          f"expected K1/K2/K3/K4 {want}; {n} parameters, sidecar {meta}", flush=True)
    check(got == want, f"the variant cli.train's K1/K2/K3/K4 launches {got} != {want}")
    check(counts["stft_kernel"]["fft"] == got[0] and counts["istft_kernel"]["fft"] == got[1],
          "the variant cli.train ran a kernel through another variant")
    check(n == PARAMS_MENU_MASK, f"the variant export has {n} parameters")
    check(meta == {**MASK_SIDECAR, **MENU}, f"the variant cli.train's sidecar {meta}")
    check(model.s2d_stem and model.s2d_skip == 16 and model.attn_bottleneck,
          "the sidecar did not rebuild the variant")
    return {"stft_kernel": got[0], "istft_kernel": got[1], "deconv_kernel": got[2]}


def menu_fit(torch, rows, tmp):
    """Phase 6g (c): ``fit`` of the bf16 residual ``ComplexMaskUNet`` with
    all three switches and ``pallas_deconv`` on the mixed mixer at batch 16,
    K3 at the s2d pyramid's mask-step shapes: K1 2 a train step and 1 a
    validation step, K2 1 a step, K3 4 a forward, each through its one
    variant, K4 0."""
    from audiodenoiser_torch.models import ComplexMaskUNet
    from audiodenoiser_torch.ops.cuda import (
        deconv_kernel,
        istft_kernel,
        reset_launch_counts,
        stft_kernel,
    )
    from audiodenoiser_torch.train.loop import FitConfig, fit
    from audiodenoiser_torch.train.mask import create_mask_train_state, make_mask_steps

    mixer, val_mixer = _mask_mixer(torch, 64, 7, "cuda"), _mask_mixer(torch, 8, 9, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = FitConfig(run_name="menu", output_path=os.path.join(tmp, "menu_fit"), epochs=1,
                    batch_size=16, precision="bf16", log_every=0)
    factory = lambda: create_mask_train_state(0, ComplexMaskUNet(
        dtype=torch.bfloat16, pallas_deconv=True, mask_bound=8.0, residual=True,
        zero_out_init=True, **MENU))
    reset_launch_counts()
    res = fit(cfg, lambda e: (mixer.sample_audio(gen, 16) for _ in range(MENU_STEPS)),
              lambda: (val_mixer.sample_audio(gen, 16) for _ in range(1)),
              state_factory=factory, steps=make_mask_steps(0.5, 30.0))
    counts = (stft_kernel.launches, istft_kernel.launches, deconv_kernel.launches)
    forwards = MENU_STEPS + 1
    want = (2 * MENU_STEPS + 1, forwards, 4 * forwards)
    print(f"[6g fit] {MENU_STEPS} steps + 1 validation at batch 16 with K3; history "
          f"{res['history']}; launches K1={counts[0]} K2={counts[1]} K3={counts[2]}, "
          f"expected {want}", flush=True)
    check(all(math.isfinite(v) for v in res["history"][0].values()), "the variant fit")
    check(counts == want, "the variant fit's K1/K2/K3 launches")
    require_variants("the variant fit", {"stft_kernel": "fft", "istft_kernel": "fft",
                                         "deconv_kernel": "wgmma"})
    count_off_path(rows, "the variant fit")
    return dict(zip(("stft_kernel", "istft_kernel", "deconv_kernel"), counts))


def _menu_models(torch, seed):
    """Full-width seeded trees and the two fp32 models of phase 6g (a): the
    magnitude ``UNet(s2d_stem, s2d_skip=16)`` and the residual
    ``ComplexMaskUNet`` (bound 8) with all three switches, its attention's
    output projection nonzero."""
    from audiodenoiser_torch.models import (
        ComplexMaskUNet,
        UNet,
        count_params,
        load_flax_variables,
        random_flax_variables,
    )

    skip = {"s2d_stem": True, "s2d_skip": 16}
    unet = load_flax_variables(UNet(**skip), random_flax_variables(seed, **skip))
    mask = load_flax_variables(
        ComplexMaskUNet(mask_bound=8.0, residual=True, **MENU),
        random_flax_variables(seed + 1, in_channels=3, out_channels=2, **MENU))
    check(count_params(unet) == PARAMS_S2D_SKIP and count_params(mask) == PARAMS_MENU_MASK,
          "the menu's parameter counts")
    check(float(mask.bottleneck_attn.out.weight.detach().abs().sum()) > 0,
          "the attention's output projection is zero")
    return {"unet s2d+skip16": (unet, 1), "mask s2d+skip16+attn": (mask, 3)}


def menu_fp32(torch, rng):
    """Phase 6g (a): at the whole-clip shape (257, 126), 2 clips, fp32 with
    cuDNN's TF32 off: each model live-BN and folded on the card against
    the CPU, within 1e-4 relative L2."""
    import copy

    import numpy as np

    from audiodenoiser_torch.models import fold_for_inference

    errs = {}
    for name, (model, cin) in _menu_models(torch, 21).items():
        x = torch.from_numpy(rng.standard_normal((2, cin, 257, 126)).astype("float32"))
        for form in ("live", "folded"):
            outs = {}
            for dev in ("cpu", "cuda"):
                m = copy.deepcopy(model).eval()
                m = fold_for_inference(m, torch.float32) if form == "folded" else m
                m = m.to(dev)
                with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                    outs[dev] = m(x.to(dev)).cpu().numpy()
            errs[f"{name} {form}"] = _rel(outs["cuda"], outs["cpu"])
            check(outs["cuda"].shape == (2, 1 if cin == 1 else 2, 257, 126)
                  and bool(np.isfinite(outs["cuda"]).all()),
                  f"[6g fp32] {name} {form}: shape or finiteness")
    print(f"[6g fp32] card vs CPU at (257, 126), rel L2: {json.dumps(errs)}", flush=True)
    check(all(e <= SLICE_TOL for e in errs.values()), "[6g fp32] a variant, card vs CPU")
    return errs


def menu_int8(torch, rng):
    """Phase 6g (b): the full-width ``Int8UNet`` prepared on the card and on
    the CPU (the int8 kernels equal, the scales and biases compared); the
    CPU's preparation on both devices, run on the same input (2 clips of
    |N(0, 1)| magnitudes at (257, 126)): the
    first conv's int32 accumulator bit-equal, the whole forward's relative
    L2 and its gap to the fp32 folded forward; then each layer on the
    CPU's own input for that layer, on both devices: the quantized inputs'
    elements that differ (rounding flips in ``x / s``) and whether the
    layer's output is bit-equal, so a gap is placed where it starts."""
    import copy

    import numpy as np

    from audiodenoiser_torch.models import (
        UNet,
        fold_for_inference,
        load_flax_variables,
        prepare_int8,
        random_flax_variables,
    )
    from audiodenoiser_torch.models.int8 import quant_act

    model = load_flax_variables(UNet(), random_flax_variables(22)).eval()
    q_cpu = prepare_int8(model)
    prepared = prepare_int8(model.cuda())  # the card's own preparation, compared
    q_dev = copy.deepcopy(q_cpu).cuda()  # the CPU's, so the forwards share every weight
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        x = torch.from_numpy(np.abs(rng.standard_normal((2, 1, 257, 126))).astype(np.float32))
        f32 = fold_for_inference(model, torch.float32)(x.cuda()).cpu().numpy()
    model.cpu()
    same = {name: (torch.equal(layer.weight.cpu(), q_cpu.layers[name].weight),
                   float((layer.scale.cpu() - q_cpu.layers[name].scale).abs().max()),
                   float((layer.bias.cpu() - q_cpu.layers[name].bias).abs().max()))
            for name, layer in prepared.layers.items()}
    del prepared
    check(all(w for w, _, _ in same.values()), "[6g int8] the card's int8 kernels")
    first = x.permute(0, 2, 3, 1).contiguous()
    acc_cpu = q_cpu.layers["down0_conv0"].accumulate(first)[0]
    acc_dev = q_dev.layers["down0_conv0"].accumulate(first.cuda())[0].cpu()
    inputs = {}
    hooks = [layer.register_forward_pre_hook(
        lambda mod, args, name=name: inputs.__setitem__(name, args[0]))
        for name, layer in q_cpu.layers.items()]
    out_cpu = q_cpu(x).numpy()
    for h in hooks:
        h.remove()
    out_dev = q_dev(x.cuda()).cpu().numpy()
    parted = {}
    for name, h in inputs.items():
        flips = int((quant_act(h)[0] != quant_act(h.cuda())[0].cpu()).sum())
        equal = torch.equal(q_cpu.layers[name](h), q_dev.layers[name](h.cuda()).cpu())
        if flips or not equal:
            parted[name] = {"input_flips": flips, "output_equal": equal}
    rel = _rel(out_dev, out_cpu)
    gap = _rel(out_dev, f32)
    print(f"[6g int8] full width: prepared on card and CPU, kernels equal, scales and biases "
          f"apart by at most {max(v[1] for v in same.values()):.3e} / "
          f"{max(v[2] for v in same.values()):.3e}; first conv's int32 accumulator equal "
          f"{torch.equal(acc_dev, acc_cpu)} ({acc_cpu.numel()} elements); whole forward card vs "
          f"CPU rel L2 {rel:.3e}; layers that part on the CPU's own inputs {json.dumps(parted)}; "
          f"int8 vs fp32 folded on the card rel L2 {gap:.3e}", flush=True)
    check(torch.equal(acc_dev, acc_cpu), "[6g int8] the first conv's accumulator")
    check(rel <= 1e-5 and not parted, "[6g int8] the forward, card vs CPU")
    check(bool(np.isfinite(out_dev).all()) and out_dev.shape == x.shape,
          "[6g int8] the card's forward")
    return {"int8_card_vs_cpu": rel, "int8_vs_fp32": gap, "parted": parted}


def menu_bench(torch, card):
    """Phase 6g (d): the variant legs at batch 256, each with its device
    breakdown by kernel: s2d and s2d_skip 16 folded in noisy-phase mode,
    int8 (with its peak memory), all three switches folded in complex-mask
    mode, and the s2d training leg."""
    from audiodenoiser_torch.eval.bench import run_bench, run_train_bench
    from audiodenoiser_torch.ops.cuda import reset_launch_counts

    out = {}
    for label, kw in (("s2d", {"s2d": True}), ("s2d_skip16", {"s2d": True, "s2d_skip": 16}),
                      ("int8", {"mode": "int8"}),
                      ("mask_menu", {"mode": "complex_mask", "s2d": True, "s2d_skip": 16,
                                     "attn": True})):
        torch.cuda.empty_cache()
        reset_launch_counts()
        r = run_bench(batch_size=256, clip_seconds=2.0, iters=10, profile_iters=3, **kw)
        require_variants(f"the {label} bench", {"stft_kernel": "fft", "istft_kernel": "fft"})
        prof = r.pop("profile")
        out[label] = {"frames_per_sec": r["value"], "batch_ms": r["batch_ms"],
                      "peak_memory_gib": r["peak_memory_gib"],
                      "device_busy_ms": prof["device_busy_ms"],
                      "idle_share": prof.get("idle_share", "not measured")}
        print(f"[6g bench] {label}: {json.dumps(r)}; profile "
              f"{json.dumps({k: v for k, v in prof.items() if k != 'top'})}", flush=True)
        for row in prof.get("top", [])[:6]:
            print(f"[6g bench] {label} profile: {row['ms']:.4f} ms {row['share']:.3f} "
                  f"{row['kernel']}", flush=True)
        check(r["value"] > 0, f"the {label} bench measured nothing")
    torch.cuda.empty_cache()
    r = run_train_bench(256, profile_iters=3, s2d=True)
    top = r.pop("s2d_train_profile_top", [])
    out["s2d_train"] = r
    print(f"[6g train leg] s2d at batch 256: {json.dumps(r)}; {card}", flush=True)
    for row in top[:6]:
        print(f"[6g train leg] profile: {row['ms']:.4f} ms {row['share']:.3f} {row['kernel']}",
              flush=True)
    check(math.isfinite(r["s2d_train_last_loss"]) and r["s2d_train_samples_per_sec"] > 0,
          "the s2d training leg")
    return out


def phase_menu(torch, rng, rows, card, wavs):
    """Phase 6g: the rest of the model menu (the s2d stem, its refinement
    path, the attention bottleneck, int8 compute)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_6g_")
    started = None
    try:
        export, started = menu_cli_start(tmp, wavs)
        fp32 = menu_fp32(torch, rng)
        int8 = menu_int8(torch, rng)
        launches = menu_cli_check(torch, started, export)
        for name, n in menu_fit(torch, rows, tmp).items():
            launches[name] += n
        served = _serve_mask_export(torch, rng, rows, export, "6g serve", lambda m: (
            m.s2d_stem and m.s2d_skip == 16 and m.attn is not None and m.mask_bound == 8.0))
        for name, n in launches.items():
            n += served.get(name, 0)
            rows[name]["launches"] += n
            rows[name]["launches_menu"] = n
        return {"fp32": fp32, "int8": int8, "bench": menu_bench(torch, card)}
    finally:
        if started is not None and started[1].poll() is None:  # a check failed first
            started[1].kill()
            started[1].wait()
        shutil.rmtree(tmp, ignore_errors=True)


MESH_STEPS = 4  # phase 6h's cli.train runs: 4 bf16 steps and 1 validation at batch 16
MESH_TOL = 1e-6  # relative L2 a tensor, a meshed step or runner call against the unmeshed
GLOO_TOL = 1e-5  # relative, two gloo ranks' fp32 step against one rank's: loss, grad norm
MESH_CLI = (("off", ["--mesh", "off"]), ("on", ["--mesh", "on"]),
            ("fsdp", ["--mesh", "on", "--fsdp"]))


def mesh_cli_start(tmp, wavs):
    """Phase 6h (a, e), started together: ``cli.train`` of the magnitude
    U-Net without a mesh, with ``--mesh on`` (a world-size-1 NCCL group) and
    with ``--mesh on --fsdp``, and ``--mesh on --model_parallel 2``, which
    one card cannot hold."""
    base = ["audiodenoiser_torch.cli.train", "--base_dataset_path", wavs, "--pipeline",
            "on_device", "--noise_type", "white", "--epochs", "1", "--steps_per_epoch",
            str(MESH_STEPS), "--batch_size", "16"]
    runs = {label: _start_cli(f"cli.train mesh {label}", base + [
        "--output_path", os.path.join(tmp, f"mesh_{label}"), *extra], tmp)
        for label, extra in MESH_CLI}
    runs["mp2"] = _start_cli("cli.train mesh mp2", base + [
        "--output_path", os.path.join(tmp, "mesh_mp2"), "--mesh", "on", "--model_parallel",
        "2"], tmp)
    return runs


def mesh_cli_check(runs):
    """Phase 6h (a, e): each run's exit, mesh, losses and ``[launches]``
    line (K1 a train and a validation step's mixer, K3 0: cli.train's
    upsamplings are cuDNN's, as JAX's); the model_parallel 2 run stops with
    JAX's error and a nonzero exit code."""
    launches = {"stft_kernel": 0}
    for label, _ in MESH_CLI:
        out, wall = _finish_cli(runs[label])
        lines = [ln for ln in out.splitlines() if ln.startswith("[launches] ")]
        check(len(lines) == 1, f"cli.train mesh {label} printed no [launches] line")
        counts = json.loads(lines[0][len("[launches] "):])
        got = (counts["stft_kernel"]["launches"], counts["deconv_kernel"]["launches"],
               counts["overlap_add_kernel"]["launches"])
        losses = re.findall(r"Train Loss: ([0-9.]+) \| Validation Loss: ([0-9.]+)", out)
        meshed = "Device mesh: {'data': 1, 'model': 1}" in out
        print(f"[6h cli.train] {label}: exit 0 in {wall:.1f} s; mesh {meshed}; losses "
              f"{losses}; launches K1/K3/K4 {got}", flush=True)
        check(meshed == (label != "off"), f"cli.train mesh {label} mesh {meshed}")
        check(got == (MESH_STEPS + 1, 0, 0) and counts["stft_kernel"]["fft"] == got[0],
              f"cli.train mesh {label}'s launches {got}")
        check(len(losses) == 1 and all(math.isfinite(float(v)) for v in losses[0]),
              f"cli.train mesh {label}'s losses")
        launches["stft_kernel"] += got[0]
    label, proc, log, t0, watcher, ended = runs["mp2"]
    watcher.join(timeout=600)
    log.seek(0)
    out = log.read()
    said = "1 devices not divisible by model_parallel=2" in out
    print(f"[6h cli.train] mp2: exit {proc.returncode}; JAX's error {said}", flush=True)
    check(bool(ended) and proc.returncode != 0 and said,
          "cli.train --mesh on --model_parallel 2 on one card did not stop with JAX's error")
    return launches


def _mesh_fit_state(torch, family, mesh_on, tmp, variables, batch):
    """One full-width fp32 step through ``fit`` (cuDNN deterministic), with
    or without a world-size-1 mesh: the state dict after it, full tensors."""
    from audiodenoiser_torch.models import ComplexMaskUNet, UNet
    from audiodenoiser_torch.train.loop import FitConfig, create_train_state, fit
    from audiodenoiser_torch.train.mask import create_mask_train_state, make_mask_steps

    if family == "mask":
        factory = lambda: create_mask_train_state(0, ComplexMaskUNet(
            mask_bound=8.0, residual=True, pallas_deconv=True), variables=variables)
        steps = make_mask_steps(0.5, 30.0)
    else:
        factory = lambda: create_train_state(0, UNet(pallas_deconv=True), variables=variables)
        steps = None
    cfg = FitConfig(run_name=f"{family}_{mesh_on}", output_path=os.path.join(tmp, "fp32"),
                    epochs=1, batch_size=4, precision="f32", log_every=0, use_mesh=mesh_on)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                    allow_tf32=False):
        res = fit(cfg, lambda e: iter([batch]), lambda: iter([batch]), state_factory=factory,
                  steps=steps)
    state = res["state"]
    sd = state.layout.full_state_dict(state.model) if mesh_on else state.model.state_dict()
    return res["history"][0], {k: v.detach().float().cpu() for k, v in sd.items()}


def mesh_step_fp32(torch, tmp):
    """Phase 6h (b): one full-width fp32 step through ``fit`` with
    ``use_mesh=True`` (world size 1) against the unmeshed step, for both
    families, every tensor within MESH_TOL."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.models import random_flax_variables
    from audiodenoiser_torch.data.synth import synth_chunks

    gen = torch.Generator(device="cuda").manual_seed(21)
    batches = {"unet": OnDeviceMixer(synth_chunks(8, seed=21), "white").sample(gen, 4),
               "mask": _mask_mixer(torch, 8, 22, "cuda").sample_audio(gen, 4)}
    out = {}
    for family, kw in (("unet", {}), ("mask", dict(in_channels=3, out_channels=2))):
        variables = random_flax_variables(23, **kw)
        (h0, plain), (h1, meshed) = (_mesh_fit_state(torch, family, on, tmp, variables,
                                                     batches[family]) for on in (False, True))
        errs = {k: _rel_l2(meshed[k], plain[k]) for k in plain if plain[k].is_floating_point()}
        # the conv biases that feed a train-mode BatchNorm step on rounding
        # noise, which cuDNN sums in an order of its own: printed apart
        held = [k for k in errs if not k.endswith(BN_FED)]
        worst = max(held, key=errs.get)
        bn_fed = max(errs[k] for k in errs if k.endswith(BN_FED))
        out[family] = {"tensors": len(held), "worst": worst, "worst_rel_l2": errs[worst],
                       "bn_fed_biases_rel_l2": bn_fed, "loss": (h0["train"], h1["train"])}
        print(f"[6h fp32] {family}: meshed vs unmeshed step, {len(held)} tensors, worst "
              f"{worst} {errs[worst]:.3e}, the BN-fed conv biases {bn_fed:.3e}; losses "
              f"{h0['train']} / {h1['train']}", flush=True)
        check(meshed.keys() == plain.keys() and errs[worst] <= MESH_TOL,
              f"the meshed fp32 {family} step left the unmeshed one")
    return out


def mesh_fit_k3(torch, rows, tmp):
    """Phase 6h (b): a meshed bf16 ``fit`` of ``UNet(pallas_deconv=True)``
    (2 steps and 1 validation at batch 16, world size 1): K3 4 a forward,
    through wgmma alone, K4 0."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.ops.cuda import deconv_kernel, reset_launch_counts
    from audiodenoiser_torch.data.synth import synth_chunks
    from audiodenoiser_torch.train.loop import FitConfig, create_train_state, fit

    batches = _mixer_batches(torch, OnDeviceMixer(synth_chunks(32, seed=24), "white"), 16, 3, 25)
    cfg = FitConfig(run_name="k3", output_path=os.path.join(tmp, "k3"), epochs=1,
                    batch_size=16, precision="bf16", log_every=0, use_mesh=True)
    reset_launch_counts()
    res = fit(cfg, lambda e: iter(batches[:2]), lambda: iter(batches[2:]),
              state_factory=lambda: create_train_state(0, UNet(dtype=torch.bfloat16,
                                                               pallas_deconv=True)))
    n = deconv_kernel.launches
    print(f"[6h fit K3] meshed bf16 fit, 2 steps + 1 validation: K3 {n}, history "
          f"{res['history']}", flush=True)
    check(n == 4 * 3 and all(math.isfinite(v) for v in res["history"][0].values()),
          "the meshed fit with pallas_deconv")
    require_variants("the meshed fit", {"deconv_kernel": "wgmma"})
    count_off_path(rows, "the meshed fit")
    return {"deconv_kernel": n}


def _gloo_ranks(tmp):
    """Phase 6h (d), started: two ranks sharing the card over gloo."""
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = {**os.environ, "PYTHONPATH": HERE, "RANK": str(rank), "WORLD_SIZE": "2",
               "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        log = open(os.path.join(tmp, f"gloo_{rank}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.mesh_gloo_rank()"],
            cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT, text=True), log))
    return procs


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_gloo_rank() -> None:
    """One of phase 6h (d)'s two ranks on one card (gloo carries CUDA
    tensors; NCCL refuses two ranks on one device): one fp32 step of the
    full-width U-Net on a (2, 1) mesh against one rank's step on the whole
    batch (rank 0 takes both), printed as one JSON line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from audiodenoiser_torch.models import UNet, random_flax_variables
    from audiodenoiser_torch.parallel.distributed import maybe_initialize
    from audiodenoiser_torch.parallel.mesh import make_mesh, shard_batch, shard_train_state
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    torch.backends.cudnn.allow_tf32 = False
    check(maybe_initialize("cuda", backend="gloo"), "no launcher environment")
    mesh = make_mesh(model_parallel=1, device="cuda")
    variables = random_flax_variables(26)
    rng = np.random.default_rng(27)
    noisy = torch.from_numpy(np.abs(rng.standard_normal((4, 1, 256, 64))).astype(np.float32))
    clean = (0.8 * noisy + 0.1 * torch.rand(noisy.shape, generator=torch.Generator()
                                            .manual_seed(28))).cuda()
    noisy = noisy.cuda()
    state = shard_train_state(create_train_state(0, UNet(), variables=variables), mesh)
    state, losses = train_step(state, shard_batch(noisy, mesh), shard_batch(clean, mesh))
    total = losses.total.detach().clone()
    dist.all_reduce(total, group=mesh.get_group("data"))
    out = {"rank": dist.get_rank(), "loss": float(total) / 2,
           "grad_norm": float(state.grad_norm)}
    if dist.get_rank() == 0:
        ref, ref_losses = train_step(create_train_state(0, UNet(), variables=variables),
                                     noisy, clean)
        out.update(ref_loss=float(ref_losses.total), ref_grad_norm=float(ref.grad_norm))
    print("[gloo] " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def mesh_gloo_check(procs):
    """Phase 6h (d): both ranks exit 0; the two-rank loss and global norm
    within GLOO_TOL of one rank's, the same on both ranks."""
    reports = []
    for rank, (proc, log) in enumerate(procs):
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        out = log.read()
        for line in out.strip().splitlines()[-3:]:
            print(f"[6h gloo rank {rank}] {line}", flush=True)
        check(proc.returncode == 0, f"gloo rank {rank} exited {proc.returncode}")
        reports.append(json.loads(next(ln for ln in out.splitlines()
                                       if ln.startswith("[gloo] "))[len("[gloo] "):]))
    a, b = reports
    loss_gap = abs(a["loss"] - a["ref_loss"]) / abs(a["ref_loss"])
    norm_gap = abs(a["grad_norm"] - a["ref_grad_norm"]) / a["ref_grad_norm"]
    print(f"[6h gloo] dp 2 on one card: loss {a['loss']} vs one rank {a['ref_loss']} "
          f"({loss_gap:.2e}), global norm {a['grad_norm']} vs {a['ref_grad_norm']} "
          f"({norm_gap:.2e})", flush=True)
    check(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"],
          "the two gloo ranks disagree")
    check(loss_gap <= GLOO_TOL and norm_gap <= GLOO_TOL,
          "the two-rank step left the one-rank step")
    return {"loss_gap": loss_gap, "norm_gap": norm_gap}


def mesh_train_bench(torch, card):
    """Phase 6h (a): bf16 steps of the full-width U-Net at batch 16 on the
    white mixer, unmeshed, on a world-size-1 mesh and with fsdp, timed in
    turns (each 10 steps after 3, in the order unmeshed, mesh, fsdp, fsdp,
    mesh, unmeshed): ms a step, and peak memory above what was allocated
    before its window."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.parallel.mesh import make_mesh, shard_train_state
    from audiodenoiser_torch.data.synth import synth_chunks
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    batches = _mixer_batches(torch, OnDeviceMixer(synth_chunks(32, seed=29), "white"), 16, 13, 30)
    mesh = make_mesh(device="cuda")
    states = {}
    for label in ("unmeshed", "mesh", "fsdp"):
        state = create_train_state(0, UNet(dtype=torch.bfloat16))
        if label != "unmeshed":
            state = shard_train_state(state, mesh, fsdp=label == "fsdp")
        for noisy, clean in batches[:3]:
            state, _ = train_step(state, noisy, clean)
        states[label] = state
    out = {label: {"step_ms": [], "peak_gib": []} for label in states}
    for label in ("unmeshed", "mesh", "fsdp", "fsdp", "mesh", "unmeshed"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for noisy, clean in batches[3:]:
            states[label], losses = train_step(states[label], noisy, clean)
        torch.cuda.synchronize()
        out[label]["step_ms"].append((time.perf_counter() - t0) * 1e3 / (len(batches) - 3))
        out[label]["peak_gib"].append((torch.cuda.max_memory_allocated() - base) / 2**30)
        out[label]["loss"] = float(losses.total)
    for r in out.values():
        r["mean_step_ms"] = sum(r["step_ms"]) / len(r["step_ms"])
    print(f"[6h train bench] bf16 batch 16, ms a step and peak GiB in turns: "
          f"{json.dumps(out)}; {card}", flush=True)
    check(all(math.isfinite(r["loss"]) for r in out.values()), "the meshed training bench")
    del states
    torch.cuda.empty_cache()
    return out


def _frames_per_sec(torch, runner, audio, iters=20):
    for _ in range(3):
        runner.denoise_audio(audio)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [runner.denoise_audio(audio) for _ in range(iters)]
    torch.cuda.synchronize()
    del outs
    frames = audio.shape[0] * (1 + audio.shape[1] // HOP) * iters
    return frames / (time.perf_counter() - t0)


def mesh_runner(torch, rows, card):
    """Phase 6h (c): the folded bf16 runner at the bench shape (256 clips
    of 2 s) on a world-size-1 mesh against the unmeshed runner over the same
    weights and batch (within MESH_TOL; K1 and K2 once a call, FFT
    entries), then both runners' frames/s."""
    import numpy as np

    from audiodenoiser_torch.eval.bench import build_runner
    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.ops.cuda import istft_kernel, reset_launch_counts, stft_kernel
    from audiodenoiser_torch.parallel.mesh import make_mesh

    plain = build_runner(0, device="cuda")
    meshed = DenoiserRunner(build_runner(0, device="cuda").model, device="cuda",
                            mesh=make_mesh(device="cuda"))
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(np.clip(rng.standard_normal((256, 2 * SR)) * 0.2, -1, 1)
                             .astype(np.float32)).cuda()
    want = plain.denoise_audio(audio)
    reset_launch_counts()
    got = meshed.denoise_audio(audio)
    torch.cuda.synchronize()
    counts = {"stft_kernel": stft_kernel.launches, "istft_kernel": istft_kernel.launches}
    err = _rel_l2(got, want)
    require_variants("the meshed runner", {"stft_kernel": "fft", "istft_kernel": "fft"})
    count_off_path(rows, "the meshed runner")
    fps = {"unmeshed": _frames_per_sec(torch, plain, audio),
           "mesh": _frames_per_sec(torch, meshed, audio)}
    print(f"[6h runner] meshed vs unmeshed at 256 x 2 s: rel L2 {err:.3e}, launches {counts}; "
          f"frames/s {json.dumps(fps)} ({fps['mesh'] / fps['unmeshed']:.4f}x); {card}",
          flush=True)
    check(err <= MESH_TOL and counts == {"stft_kernel": 1, "istft_kernel": 1},
          "the meshed runner left the unmeshed one")
    return counts, fps


def phase_mesh(torch, rows, card, wavs):
    """Phase 6h: the ('data', 'model') mesh on the one card."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_6h_")
    runs, gloo = {}, []
    try:
        runs = mesh_cli_start(tmp, wavs)
        gloo = _gloo_ranks(tmp)
        fp32 = mesh_step_fp32(torch, tmp)
        launches = mesh_fit_k3(torch, rows, tmp)
        launches.update(mesh_cli_check(runs))
        out = {"fp32": fp32, "gloo": mesh_gloo_check(gloo)}
        counts, out["runner_fps"] = mesh_runner(torch, rows, card)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        out["train_bench"] = mesh_train_bench(torch, card)
        for name, n in launches.items():
            rows[name]["launches"] += n
            rows[name]["launches_mesh"] = n
        return out
    finally:
        for started in runs.values():  # a check failed first
            if started[1].poll() is None:
                started[1].kill()
                started[1].wait()
        for proc, _ in gloo:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


PP_TOL = 1e-5  # relative L2, the pipelined fp32 forward against the monolithic U-Net
PP_STEP_TOL = 1e-4  # relative L2 a tensor, a 1F1B fp32 step against per-microbatch accumulation
PP_CLI_STEPS = 2  # phase 6i's cli.train --pp_stages runs: 2 bf16 steps and 1 validation
SEQ_TOL = 1e-5  # relative L2, the sharded 60 s clip against the padded oracle's iSTFT
EP_TOL = 1e-6  # relative L2, the expert-parallel dispatch against the bucketed one (fp32)
LONG_CLIP_S = 60  # (c)'s clip at 8 kHz: 3,751 frames
EP_CLIPS = 64  # (d)'s batch of 2 s clips
EP_MEMORY_FRACTION = 0.15  # of the card's memory, each of (d)'s four ranks


def pp_cli_start(tmp, wavs):
    """Phase 6i (b), started first: ``cli.train --pp_stages 1`` (the one
    card holds the one stage) for 2 steps and a validation, exported; and
    ``--pp_stages 2``, which must stop with JAX's divisibility message."""
    base = ["audiodenoiser_torch.cli.train", "--base_dataset_path", wavs, "--pipeline",
            "on_device", "--noise_type", "white", "--epochs", "1", "--steps_per_epoch",
            str(PP_CLI_STEPS), "--batch_size", "16", "--pp_microbatches", "4"]
    return {"s1": _start_cli("cli.train pp 1", base + [
                "--output_path", os.path.join(tmp, "pp1"), "--pp_stages", "1",
                "--export_dir", os.path.join(tmp, "pp_saved")], tmp),
            "s2": _start_cli("cli.train pp 2", base + [
                "--output_path", os.path.join(tmp, "pp2"), "--pp_stages", "2"], tmp)}


def pp_cli_check(torch, runs, tmp):
    """Phase 6i (b): the one-stage run's exit, pipeline log line, losses and
    ``[launches]`` (K1 a train and a validation step's mixer, K3 and K4 0),
    its export served by ``load_model_for_noise``; the two-stage run's
    nonzero exit with JAX's message."""
    import numpy as np

    from audiodenoiser_torch.eval.runner import DenoiserRunner, load_model_for_noise

    out, wall = _finish_cli(runs["s1"])
    lines = [ln for ln in out.splitlines() if ln.startswith("[launches] ")]
    check(len(lines) == 1, "cli.train --pp_stages 1 printed no [launches] line")
    counts = json.loads(lines[0][len("[launches] "):])
    got = (counts["stft_kernel"]["launches"], counts["deconv_kernel"]["launches"],
           counts["overlap_add_kernel"]["launches"])
    losses = re.findall(r"Train Loss: ([0-9.]+) \| Validation Loss: ([0-9.]+)", out)
    piped = "1F1B pipeline-parallel run: mesh {'data': 1, 'stage': 1}, 4 microbatches x 4" in out
    model = load_model_for_noise("white", os.path.join(tmp, "pp_saved"), device="cuda")
    clip = torch.from_numpy(np.clip(np.random.default_rng(50).standard_normal(2 * SR) * 0.2,
                                    -1, 1).astype(np.float32)).cuda()
    served = DenoiserRunner(model, device="cuda").denoise_audio(clip[None])
    print(f"[6i cli.train] --pp_stages 1: exit 0 in {wall:.1f} s; pipeline {piped}; losses "
          f"{losses}; launches K1/K3/K4 {got}; export served {tuple(served.shape)}", flush=True)
    check(piped and got == (PP_CLI_STEPS + 1, 0, 0) and counts["stft_kernel"]["fft"] == got[0],
          f"cli.train --pp_stages 1: pipeline {piped}, launches {got}")
    check(len(losses) == 1 and all(math.isfinite(float(v)) for v in losses[0]),
          "cli.train --pp_stages 1's losses")
    check(served.shape == (1, 2 * SR) and bool(torch.isfinite(served).all()),
          "the --pp_stages export did not serve")
    label, proc, log, t0, watcher, ended = runs["s2"]
    watcher.join(timeout=600)
    log.seek(0)
    said = "--pp_stages 2 does not divide 1 devices" in log.read()
    print(f"[6i cli.train] --pp_stages 2: exit {proc.returncode}; JAX's message {said}",
          flush=True)
    check(bool(ended) and proc.returncode != 0 and said,
          "cli.train --pp_stages 2 on one card did not stop with JAX's message")
    return got[0]


def _full_sd(seed, **kw):
    from audiodenoiser_torch.models import random_flax_variables, state_dict_from_flax

    return state_dict_from_flax(random_flax_variables(seed, **kw))


def _peak_run(torch, fn, reps: int = 5, warmup: int = 2):
    """ms a call (wall clock over ``reps`` after ``warmup``) and the peak
    GiB above what was allocated before."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / reps,
            (torch.cuda.max_memory_allocated() - base) / 2**30)


def pp_forward(torch, card):
    """Phase 6i (a): ``PipelinedDenoiser`` at 2 and 4 stages on ``cuda:0``,
    4 microbatches, full width: fp32 against the monolithic U-Net on the
    same weights (cuDNN deterministic, no TF32), then bf16 at the bench
    batch (256 x 2 s magnitudes) at 1, 2 and 4 stages against the
    monolithic forward: frames/s and peak memory."""
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.parallel.pipeline import PipelinedDenoiser

    sd = _full_sd(40)
    gen = torch.Generator(device="cuda").manual_seed(40)
    x = torch.rand((8, 1, 257, 126), device="cuda", generator=gen)
    out = {"fp32_rel_l2": {}}
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                    allow_tf32=False):
        mono = UNet().cuda().eval()
        mono.load_state_dict(sd)
        with torch.inference_mode():
            want = mono(x)
        for s in (2, 4):
            got = PipelinedDenoiser(sd, devices=["cuda:0"] * s)(x, microbatches=4)
            out["fp32_rel_l2"][s] = _rel_l2(got, want)
    del mono
    print(f"[6i pipeline] fp32 at 8 x (257, 126), 4 microbatches, against the monolithic "
          f"U-Net: rel L2 {json.dumps(out['fp32_rel_l2'])}", flush=True)
    check(all(e <= PP_TOL for e in out["fp32_rel_l2"].values()),
          "the pipelined fp32 forward left the monolithic U-Net")
    x = torch.rand((256, 1, 257, 126), device="cuda", generator=gen)
    frames = 256 * 126
    mono = UNet(dtype=torch.bfloat16).cuda().eval()
    mono.load_state_dict(sd)
    runs = {"monolithic": lambda: mono(x)}
    for s in (1, 2, 4):
        pipe = PipelinedDenoiser(sd, devices=["cuda:0"] * s, dtype=torch.bfloat16)
        runs[f"stages_{s}"] = lambda p=pipe: p(x, microbatches=4)
    bench = {}
    with torch.inference_mode():
        for label, fn in runs.items():
            ms, gib = _peak_run(torch, fn)
            bench[label] = {"ms": ms, "frames_per_sec": frames / ms * 1e3, "peak_gib": gib}
    out["bf16"] = bench
    print(f"[6i pipeline] bf16 at 256 x (257, 126), 4 microbatches, every stage on cuda:0: "
          f"{json.dumps(bench)}; {card}", flush=True)
    del runs, mono
    torch.cuda.empty_cache()
    return out


def pp_train(torch, card):
    """Phase 6i (b): the 1F1B trainer at 2 and 4 stages on ``cuda:0``,
    M = 4, batch 16 of (256, 64) crops. One fp32 step against ``fit``'s
    step with ``grad_accum`` 4 over the same microbatches (BatchNorm on each
    microbatch; cuDNN deterministic, no TF32): losses within 1e-5
    relative, every tensor within PP_STEP_TOL but the conv biases that feed
    a train-mode BatchNorm, within 4 x lr. Then bf16 steps against the
    monolithic step at batch 16: ms a step and peak memory."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.models import UNet, random_flax_variables
    from audiodenoiser_torch.parallel.pipeline_train import PipelineTrainer
    from audiodenoiser_torch.data.synth import synth_chunks
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    lr = 1e-4
    variables = random_flax_variables(41)
    sd = _full_sd(41)
    mixer = OnDeviceMixer(synth_chunks(32, seed=42), "white")
    (noisy, clean), = _mixer_batches(torch, mixer, 16, 1, 43)
    micro = (noisy.reshape(4, 4, *noisy.shape[1:]), clean.reshape(4, 4, *clean.shape[1:]))
    out = {}
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                    allow_tf32=False):
        state = create_train_state(0, UNet(), variables=variables, learning_rate=lr,
                                   grad_accum=4)
        losses = []
        for m in range(4):
            state, l = train_step(state, micro[0][m], micro[1][m])
            losses.append(float(l.total))
        want_loss = sum(losses) / 4
        want = {k: v.detach().float().cpu() for k, v in state.model.state_dict().items()}
        del state
        for s in (2, 4):
            trainer = PipelineTrainer(["cuda:0"] * s, micro_batch=4, n_micro=4,
                                      input_shape=(1, 256, 64), learning_rate=lr)
            pstate, loss = trainer.step(trainer.init(sd), *micro)
            got = trainer.unpack_state(pstate)
            errs = {k: _rel_l2(got[k], want[k]) for k in want if want[k].is_floating_point()}
            held = [k for k in errs if not k.endswith(BN_FED)]
            worst = max(held, key=errs.get)
            bn_fed = max(float((got[k] - want[k]).abs().max()) for k in errs
                         if k.endswith(BN_FED))
            loss_gap = abs(float(loss) - want_loss) / want_loss
            out[s] = {"loss": float(loss), "ref_loss": want_loss, "loss_gap": loss_gap,
                      "worst": worst, "worst_rel_l2": errs[worst], "bn_fed_max_abs": bn_fed}
            print(f"[6i 1F1B fp32] {s} stages: loss {float(loss)} vs {want_loss} "
                  f"({loss_gap:.2e}); {len(held)} tensors, worst {worst} {errs[worst]:.3e}; "
                  f"the BN-fed conv biases max |diff| {bn_fed:.3e} (lr {lr})", flush=True)
            check(loss_gap <= 1e-5 and errs[worst] <= PP_STEP_TOL and bn_fed <= 4 * lr,
                  f"the {s}-stage 1F1B step left per-microbatch accumulation")
            del trainer, pstate
    bench = {}
    states = {"monolithic": create_train_state(0, UNet(dtype=torch.bfloat16))}
    runs = {"monolithic": lambda: train_step(states["monolithic"], noisy, clean)}
    for s in (2, 4):
        trainer = PipelineTrainer(["cuda:0"] * s, micro_batch=4, n_micro=4,
                                  input_shape=(1, 256, 64), dtype=torch.bfloat16)
        states[s] = trainer.init(sd)
        runs[f"stages_{s}"] = lambda t=trainer, s=s: t.step(states[s], *micro)
    for label, fn in runs.items():
        ms, gib = _peak_run(torch, fn)
        bench[label] = {"step_ms": ms, "peak_gib": gib}
    out["bf16"] = bench
    print(f"[6i 1F1B bench] bf16 batch 16 (M 4 x 4), every stage on cuda:0, ms a step and "
          f"peak GiB: {json.dumps(bench)}; {card}", flush=True)
    del states
    torch.cuda.empty_cache()
    return out


def _long_clip(torch):
    import numpy as np

    rng = np.random.default_rng(51)
    return torch.from_numpy(np.clip(rng.standard_normal(LONG_CLIP_S * SR) * 0.2, -1, 1)
                            .astype(np.float32)).cuda()


def _padded_reference(torch, model, wav):
    """The oracle's waveform: K1's STFT, ``reference_padded_forward``, K2's
    noisy-phase iSTFT."""
    from audiodenoiser_torch.dsp import stft as stft_lib
    from audiodenoiser_torch.parallel.spatial import reference_padded_forward

    with torch.inference_mode():
        mag, phase = stft_lib.magphase(stft_lib.stft(wav, N_FFT, HOP, precision="kernel"))
        den = reference_padded_forward(model, mag)
        return stft_lib.istft(den.float().clamp_min(0.0) * phase, HOP, n_fft=N_FFT,
                              length=wav.shape[-1], precision="kernel")


def seq_long_clip(torch, rows, card):
    """Phase 6i (c): a 60 s clip through ``denoise_waveform_sharded`` on a
    world-size-1 ('seq',) mesh (NCCL): K1 and K2 once each (FFT entries),
    within SEQ_TOL of the padded oracle, then its ms against the runner on
    the same clip and model (fp32, full width)."""
    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.ops.cuda import istft_kernel, reset_launch_counts, stft_kernel
    from audiodenoiser_torch.parallel.spatial import denoise_waveform_sharded, make_seq_mesh

    model = UNet().cuda().eval()
    model.load_state_dict(_full_sd(43))
    wav = _long_clip(torch)
    mesh = make_seq_mesh(device="cuda")
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                    allow_tf32=False):
        reset_launch_counts()
        got = denoise_waveform_sharded(model, wav, mesh)
        torch.cuda.synchronize()
        counts = {"stft_kernel": stft_kernel.launches, "istft_kernel": istft_kernel.launches}
        require_variants("the sharded long clip", {"stft_kernel": "fft", "istft_kernel": "fft"})
        count_off_path(rows, "the sharded long clip")
        err = _rel_l2(got, _padded_reference(torch, model, wav))
    runner = DenoiserRunner(model, device="cuda")
    with torch.inference_mode():
        times = {"sharded": _peak_run(torch, lambda: denoise_waveform_sharded(model, wav, mesh)),
                 "runner": _peak_run(torch, lambda: runner.denoise_audio(wav[None]))}
    out = {"frames": 1 + wav.shape[-1] // HOP, "rel_l2": err, "launches": counts,
           **{k: {"ms": v[0], "peak_gib": v[1]} for k, v in times.items()}}
    print(f"[6i seq] {LONG_CLIP_S} s clip ({out['frames']} frames), world size 1 (NCCL): rel L2 "
          f"{err:.3e} to the padded oracle, launches {counts}; fp32 ms and peak GiB "
          f"{json.dumps({k: out[k] for k in times})}; {card}", flush=True)
    check(err <= SEQ_TOL and counts == {"stft_kernel": 1, "istft_kernel": 1},
          "the sharded long clip")
    return out


def _gloo_ranks_start(tmp, entry: str, world: int, extra_env: dict):
    """``world`` ranks of ``chip_smoke.<entry>()`` sharing the card over
    gloo, their output to files."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": HERE, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               **extra_env}
        log = open(os.path.join(tmp, f"{entry}_{extra_env.get('PROBE', 'run')}_{rank}.log"),
                   "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.{entry}()"],
            cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT, text=True), log))
    return procs


def _gloo_init(seconds: int) -> None:
    import datetime

    from audiodenoiser_torch.parallel.distributed import maybe_initialize

    check(maybe_initialize("cuda", backend="gloo", timeout=datetime.timedelta(seconds=seconds)),
          "no launcher environment")


def gloo_probe_rank() -> None:
    """One rank of a probe of what gloo carries on CUDA tensors, in
    processes of their own (a refused exchange may abort the process):
    ``PROBE=p2p``, two ranks swap a tensor through ``batch_isend_irecv``;
    ``PROBE=a2a``, four ranks ``all_to_all_single``. Prints "[probe] ok"."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    _gloo_init(60)
    rank, world = dist.get_rank(), dist.get_world_size()
    if os.environ["PROBE"] == "p2p":
        peer = rank ^ 1
        got = torch.empty(4, device="cuda")
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, torch.full((4,), float(rank), device="cuda"), peer),
            dist.P2POp(dist.irecv, got, peer)])
        for req in reqs:
            req.wait()
        check(got.tolist() == [float(peer)] * 4, f"received {got.tolist()} from rank {peer}")
    else:
        recv = torch.empty(world, device="cuda")
        dist.all_to_all_single(recv, torch.arange(world, device="cuda", dtype=torch.float32)
                               + 10 * rank)
        check(recv.tolist() == [10.0 * j + rank for j in range(world)],
              f"received {recv.tolist()}")
    print("[probe] ok", flush=True)
    dist.destroy_process_group()


def gloo_probe_result(procs) -> str:
    """"ok" when every probe rank printed it and exited 0, else each
    failed rank's exit code and last error line."""
    for rank, (proc, log) in enumerate(procs):
        try:
            proc.wait(timeout=180)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    failed = []
    for rank, (proc, log) in enumerate(procs):
        log.seek(0)
        lines = log.read().strip().splitlines()
        if proc.returncode != 0 or "[probe] ok" not in lines:
            said = [ln for ln in lines if "rror" in ln or "what()" in ln or "xception" in ln]
            failed.append(f"rank {rank} exit {proc.returncode}: "
                          f"{(said or lines or [''])[-1].strip()[:240]}")
    return "refused: " + "; ".join(failed) if failed else "ok"


def _ep_passes(labels, n_ranks, capacity):
    """JAX's pass count: every pass empties ``capacity`` of each (rank,
    expert) bucket."""
    import numpy as np

    b_loc = len(labels) // n_ranks
    counts = [np.bincount(labels[r * b_loc:(r + 1) * b_loc], minlength=4)
              for r in range(n_ranks)]
    return int(max(-(-c // capacity) for row in counts for c in row))


def parallel_gloo_rank() -> None:
    """One of phase 6i's four ranks on one card over gloo (NCCL will not
    put two ranks on one device), after the probes (``PROBES``, their
    results as JSON). Where the point-to-point probe passed, ranks 0-1 run
    (c) on a 2-rank ('seq',) mesh: the 60 s clip, rank 0 holding it to its
    own padded oracle. Where the all-to-all probe passed, (d): each rank
    holds one full-width expert (the other slots of its mixture point at
    the same module; rank 0 keeps the four for the bucketed reference),
    ``denoise_ep`` on a (1, 4) mesh and ``denoise_ep_a2a`` at capacity
    factors 1.0 and 4.0 on 64 clips of 2 s, fp32, on the same labels.
    Prints one JSON line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from audiodenoiser_torch.eval.ensemble import (
        MixtureOfDenoisers,
        make_a2a_mesh,
        make_ep_mesh,
    )
    from audiodenoiser_torch.models import NOISE_CLASSES, NoiseClassifier, UNet
    from audiodenoiser_torch.parallel.spatial import denoise_waveform_sharded, make_seq_mesh

    torch.backends.cudnn.allow_tf32 = False
    # four ranks and the main process share the card: a cap makes cuDNN fall
    # back to algorithms with smaller workspaces (uncapped, on an H100 80GB,
    # the ranks' fp32 forwards of 64 clips took 9.6-27 GiB each)
    torch.cuda.set_per_process_memory_fraction(EP_MEMORY_FRACTION)
    _gloo_init(300)
    rank = dist.get_rank()
    out = {"rank": rank, **json.loads(os.environ["PROBES"])}
    if out["probe_p2p"] == "ok":
        mesh = make_seq_mesh(2, device="cuda")
        if mesh.get_coordinate() is not None:
            model = UNet().cuda().eval()
            model.load_state_dict(_full_sd(43))
            wav = _long_clip(torch)
            got = denoise_waveform_sharded(model, wav, mesh)
            dist.barrier(group=mesh.get_group())
            t0 = time.perf_counter()
            got = denoise_waveform_sharded(model, wav, mesh)
            torch.cuda.synchronize()
            out["seq2_ms"] = (time.perf_counter() - t0) * 1e3
            if rank == 0:
                out["seq2_rel_l2"] = _rel_l2(got, _padded_reference(torch, model, wav))
            del model
        dist.barrier()
    if out["probe_a2a"] == "ok":
        rng = np.random.default_rng(52)
        specs = torch.from_numpy(np.abs(rng.standard_normal((EP_CLIPS, 1, 257, 126)))
                                 .astype(np.float32)).cuda()
        labels = rng.integers(0, 4, EP_CLIPS)

        def expert(i):
            m = UNet().cuda().eval()
            m.load_state_dict(_full_sd(60 + i))
            return m

        own = expert(rank)
        mix = MixtureOfDenoisers({nt: own for nt in NOISE_CLASSES}, NoiseClassifier(),
                                 device="cuda")
        dense, a2a_mesh = make_ep_mesh(device="cuda"), make_a2a_mesh(device="cuda")
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            answers, times = {}, {}
            runs = {"dense": lambda: mix.denoise_ep(specs, dense, labels=labels)}
            stats = {}
            for f in (1.0, 4.0):
                stats[f] = {}
                runs[f"a2a_{f}"] = (lambda f=f: mix.denoise_ep_a2a(specs, a2a_mesh, f,
                                                                   labels=labels,
                                                                   stats=stats[f]))
            for label, fn in runs.items():
                answers[label] = fn()
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[label] = (time.perf_counter() - t0) * 1e3
                dist.barrier()
        out["ep_ms"] = times
        out["ep_stats"] = {str(f): s for f, s in stats.items()}
        out["ep_expected_passes"] = {str(f): _ep_passes(labels, 4, max(1, int(np.ceil(
            (EP_CLIPS // 4) * f / 4)))) for f in (1.0, 4.0)}
        out["ep_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if rank == 0:
            full = MixtureOfDenoisers({nt: own if i == 0 else expert(i)
                                       for i, nt in enumerate(NOISE_CLASSES)},
                                      NoiseClassifier(), device="cuda")
            with torch.inference_mode():
                want = full.denoise(specs, labels=labels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                full.denoise(specs, labels=labels)
                torch.cuda.synchronize()
            out["bucketed_ms"] = (time.perf_counter() - t0) * 1e3
            out["ep_rel_l2"] = {k: _rel_l2(v, want) for k, v in answers.items()}
        dist.barrier()
    print("[gloo4] " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def gloo4_check(procs, card):
    """Phase 6i (c, d): every rank exits 0; where a probe passed, its
    exchange's answers within their tolerance and ``n_passes`` by JAX's
    rule."""
    texts = []
    for rank, (proc, log) in enumerate(procs):
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        texts.append(log.read())
        lines = texts[-1].strip().splitlines()
        said = [ln for ln in lines if "rror" in ln or "what()" in ln] if proc.returncode else []
        for line in said[-3:] + lines[-3:]:
            print(f"[6i gloo rank {rank}] {line[:2000]}", flush=True)
    for rank, (proc, _) in enumerate(procs):
        check(proc.returncode == 0, f"gloo rank {rank} exited {proc.returncode}")
    reports = [json.loads(next(ln for ln in text.splitlines()
                               if ln.startswith("[gloo4] "))[len("[gloo4] "):])
               for text in texts]
    first = reports[0]
    if first["probe_p2p"] == "ok":
        print(f"[6i seq gloo] 2 ranks sharing the card: rel L2 {first['seq2_rel_l2']:.3e} to "
              f"the padded oracle; ms a call {[r.get('seq2_ms') for r in reports[:2]]}; {card}",
              flush=True)
        check(first["seq2_rel_l2"] <= SEQ_TOL, "the two-rank sharded clip left the oracle")
    if first["probe_a2a"] == "ok":
        print(f"[6i ep gloo] 4 ranks sharing the card, {EP_CLIPS} x 2 s, fp32: rel L2 to the "
              f"bucketed dispatch {json.dumps(first['ep_rel_l2'])}; passes "
              f"{json.dumps(first['ep_stats'])} (JAX's rule {first['ep_expected_passes']}); "
              f"ms a call {json.dumps(first['ep_ms'])} vs bucketed {first['bucketed_ms']:.1f} "
              f"on one rank; peak GiB by rank {[round(r['ep_peak_gib'], 3) for r in reports]}"
              f"; {card}", flush=True)
        check(all(e <= EP_TOL for e in first["ep_rel_l2"].values()),
              "the expert-parallel answers left the bucketed dispatch")
        check(all(first["ep_stats"][f]["n_passes"] == first["ep_expected_passes"][f]
                  for f in first["ep_expected_passes"]), "n_passes is not JAX's rule")
    return {k: v for k, v in first.items() if k != "rank"}


def phase_parallel(torch, rows, card, wavs):
    """Phase 6i: the stage pipeline, 1F1B training, the sequence-parallel
    halos and the expert-parallel dispatch on the one card."""
    from audiodenoiser_torch.cli import test as test_cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_6i_")
    runs, gloo, probes = {}, [], {}
    try:
        runs = pp_cli_start(tmp, wavs)
        probes = {kind: _gloo_ranks_start(tmp, "gloo_probe_rank", n, {"PROBE": kind})
                  for kind, n in (("p2p", 2), ("a2a", 4))}
        out = {"pipeline": pp_forward(torch, card)}
        k1_cli = pp_cli_check(torch, runs, tmp)
        found = {f"probe_{kind}": gloo_probe_result(p) for kind, p in probes.items()}
        print(f"[6i gloo probes] CUDA tensors over gloo, ranks sharing one card: "
              f"point-to-point {found['probe_p2p']!r}; all_to_all_single "
              f"{found['probe_a2a']!r}; {card}", flush=True)
        # the four ranks' fp32 forwards of 64 clips need the card to themselves
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"[6i memory] before the four ranks: {free / 2**30:.2f} of {total / 2**30:.2f} "
              f"GiB free; this process {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} reserved", flush=True)
        gloo = _gloo_ranks_start(tmp, "parallel_gloo_rank", 4, {"PROBES": json.dumps(found)})
        out["gloo"] = gloo4_check(gloo, card)
        out["seq"] = seq_long_clip(torch, rows, card)
        # one process is fewer than four ranks: the host-bucketed dispatch
        check(test_cli._ep_mesh(test_cli.parse_args(["--auto_route", "--ep", "auto"]),
                                torch.device("cuda")) is None,
              "one process took an expert-parallel mesh")
        out["train"] = pp_train(torch, card)
        launches = {"stft_kernel": out["seq"]["launches"]["stft_kernel"] + k1_cli,
                    "istft_kernel": out["seq"]["launches"]["istft_kernel"]}
        for name, n in launches.items():
            rows[name]["launches"] += n
            rows[name]["launches_parallel"] = n
        return out
    finally:
        for started in runs.values():  # a check failed first
            if started[1].poll() is None:
                started[1].kill()
                started[1].wait()
        for proc, _ in gloo + [pl for ps in probes.values() for pl in ps]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


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
        for entry in ptxas_summary(log):
            print(f"[build] {name}: {json.dumps(entry)}", flush=True)

    from audiodenoiser_torch.ops.cuda import KERNELS, reset_launch_counts

    rng = np.random.default_rng(0)
    rows = phase_kernels(torch, rng)
    rows["deconv_kernel"] = phase_deconv(torch, rng)
    rows["overlap_add_kernel"] = phase_overlap_add(torch, rng)
    rows["layer_norm_kernel"] = phase_layer_norm(torch, rng)
    rows["conv_module_kernel"] = phase_conv_module(torch, rng)
    rows["ssm_kernel"] = phase_ssm(torch, rng)
    phase_fused_conv(torch, rng)
    phase_serve(torch, rng, rows)
    mask_variables = phase_mask_serve(torch, rng, rows)
    t0 = time.perf_counter()
    phase_stream(torch, rng, rows, mask_variables, card)
    print(f"[stream] phase 3c in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_mpsenet(torch, rng, rows)
    print(f"[mpsenet] phase 3d in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_semamba(torch, rng, rows)
    print(f"[semamba] phase 3e in {time.perf_counter() - t0:.1f} s", flush=True)
    phase_slice_fp32(torch, rng)
    phase_mask_fp32(torch, rng, mask_variables)
    # phase 4c's test set and phase 6d's wavs stay here for phase 6e
    shared = tempfile.mkdtemp(prefix="chip_smoke_shared_")
    try:
        t0 = time.perf_counter()
        phase_eval(torch, rng, mask_variables, card, os.path.join(shared, "eval"))
        print(f"[eval] phase 4c in {time.perf_counter() - t0:.1f} s", flush=True)
        phase_train_step_fp32(torch)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            phase_train_fit(torch, rows, tmp)
            phase_train_cli(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        phase_mask_train(torch, rng, rows)
        t0 = time.perf_counter()
        phase_train_extras(torch, rows, card, os.path.join(shared, "6d"))
        print(f"[6d] phase 6d in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase_routed(torch, rows, card, os.path.join(shared, "eval"),
                     os.path.join(shared, "6d", "wavs"))
        print(f"[6e] phase 6e in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        student = phase_student(torch, rng, rows, card, os.path.join(shared, "6d", "wavs"))
        print(f"[6f] phase 6f in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        menu = phase_menu(torch, rng, rows, card, os.path.join(shared, "6d", "wavs"))
        print(f"[6g] phase 6g in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        mesh = phase_mesh(torch, rows, card, os.path.join(shared, "6d", "wavs"))
        print(f"[6h] phase 6h in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        parallel = phase_parallel(torch, rows, card, os.path.join(shared, "6d", "wavs"))
        print(f"[6i] phase 6i in {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(shared, ignore_errors=True)
    reset_launch_counts()
    bench = run_bench(batch_size=256, clip_seconds=2.0, iters=20, profile_iters=3)
    print(f"[bench] {json.dumps(bench)}", flush=True)
    check(bench["value"] > 0, "bench measured nothing")
    require_variants("the noisy-phase bench", {"stft_kernel": "fft", "istft_kernel": "fft"})
    reset_launch_counts()
    bench_k3 = run_bench(batch_size=256, clip_seconds=2.0, iters=10, profile_iters=3,
                         pallas_deconv=True)
    launches = {k.__name__: k.launches for k in KERNELS[:3]}
    print(f"[bench pallas_deconv] {json.dumps(bench_k3)}; launches {launches}", flush=True)
    check(bench_k3["value"] > 0 and all(n > 0 for n in launches.values()),
          "the pallas_deconv bench did not run through K1, K2 and K3")
    require_variants("the pallas_deconv bench", {"stft_kernel": "fft", "istft_kernel": "fft",
                                                 "deconv_kernel": "wgmma"})
    reset_launch_counts()
    bench_mask = run_bench(batch_size=256, clip_seconds=2.0, iters=20, profile_iters=3,
                           mode="complex_mask")
    launches = {k.__name__: k.launches for k in KERNELS[:2]}
    print(f"[bench complex_mask] {json.dumps(bench_mask)}; launches {launches}", flush=True)
    check(bench_mask["value"] > 0 and all(n > 0 for n in launches.values()),
          "the complex_mask bench did not run through K1 and K2")
    require_variants("the complex_mask bench", {"stft_kernel": "fft", "istft_kernel": "fft"})
    print(f"[bench] folded {bench['value']:.1f} frames/s ({bench['batch_ms']:.2f} ms a "
          f"batch) vs live-BN with K3 {bench_k3['value']:.1f} frames/s "
          f"({bench_k3['batch_ms']:.2f} ms) vs folded complex_mask "
          f"{bench_mask['value']:.1f} frames/s ({bench_mask['batch_ms']:.2f} ms)", flush=True)
    print(f"[bench] the width-0.25 student beside the full-width headline: noisy phase "
          f"{student['noisy_phase']['frames_per_sec']:.1f} vs {bench['value']:.1f} frames/s "
          f"({student['noisy_phase']['frames_per_sec'] / bench['value']:.3f}x), complex mask "
          f"{student['complex_mask']['frames_per_sec']:.1f} vs {bench_mask['value']:.1f} "
          f"({student['complex_mask']['frames_per_sec'] / bench_mask['value']:.3f}x); training "
          f"leg {student['train_b256']['train_samples_per_sec']:.1f} samples/s at batch 256, "
          f"{student['train_b16']['train_samples_per_sec']:.1f} at batch 16; {card}", flush=True)
    legs = menu["bench"]
    print(f"[bench] the model menu beside the full-width headline: s2d "
          f"{legs['s2d']['frames_per_sec']:.1f} ({legs['s2d']['frames_per_sec'] / bench['value']:.3f}x"
          f"), s2d_skip16 {legs['s2d_skip16']['frames_per_sec']:.1f} "
          f"({legs['s2d_skip16']['frames_per_sec'] / bench['value']:.3f}x), int8 "
          f"{legs['int8']['frames_per_sec']:.1f} ({legs['int8']['frames_per_sec'] / bench['value']:.3f}x"
          f", peak {legs['int8']['peak_memory_gib']:.2f} GiB) vs {bench['value']:.1f} frames/s; "
          f"the three switches in complex-mask mode {legs['mask_menu']['frames_per_sec']:.1f} vs "
          f"{bench_mask['value']:.1f}; s2d training leg "
          f"{legs['s2d_train']['s2d_train_samples_per_sec']:.1f} samples/s vs "
          f"{student['train_b256']['train_samples_per_sec']:.1f}; {card}", flush=True)

    print(f"[bench] the world-size-1 mesh beside the headline: meshed runner "
          f"{mesh['runner_fps']['mesh']:.1f} vs unmeshed {mesh['runner_fps']['unmeshed']:.1f} "
          f"frames/s in phase 6h ({mesh['runner_fps']['mesh'] / bench['value']:.4f}x the "
          f"headline {bench['value']:.1f}); bf16 steps at batch 16: "
          + ", ".join(f"{k} {v['mean_step_ms']:.2f} ms {max(v['peak_gib']):.2f} GiB"
                      for k, v in mesh["train_bench"].items()) + f"; {card}", flush=True)
    pipe = parallel["pipeline"]["bf16"]
    print(f"[bench] the parallel paths on the one card beside the headline: pipelined "
          f"forward (bf16, 256 x 2 s) "
          + ", ".join(f"{k} {v['frames_per_sec']:.1f}" for k, v in pipe.items())
          + f" frames/s vs the folded runner's {bench['value']:.1f}; 1F1B bf16 steps at "
          f"batch 16 " + ", ".join(f"{k} {v['step_ms']:.2f} ms"
                                   for k, v in parallel["train"]["bf16"].items())
          + f"; the {LONG_CLIP_S} s clip sharded {parallel['seq']['sharded']['ms']:.2f} ms vs "
          f"the runner's {parallel['seq']['runner']['ms']:.2f} ms; {card}", flush=True)
    check(all("launches" in r for r in rows.values()), "a kernel's launches were not read")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
