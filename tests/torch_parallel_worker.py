"""One gloo rank of the multi-rank tests (``tests/test_torch_parallel*.py``,
``tests/test_torch_pp.py``, ``tests/test_torch_spatial.py``,
``tests/test_torch_ep.py``).

  python tests/torch_parallel_worker.py SUITE RANK WORLD PORT WORKDIR

Every rank runs each scenario of the suite in order (a scenario is a set
of collectives all ranks make) and saves ``WORKDIR/SUITE_r{RANK}.pt``: a
dict of scenario -> results, or the traceback of the first failure. The
inputs come from ``WORKDIR/inputs.pt``, written by the test. This file
imports the port only, never JAX.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

NARROW = dict(features=(8, 128), bottleneck=256)  # cout 128 / 256: tp and fsdp engage


def _mesh(n=None, model_parallel=None):
    from audiodenoiser_torch.parallel.mesh import make_mesh

    return make_mesh(n, model_parallel, device="cpu")


def _member(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _global(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over the data ranks of a per-rank mean."""
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.get_group("data"))
    return x / mesh.size(0)


LR = 1e-5  # a first AdamW step moves each weight by about LR (tests/test_torch_parallel.py)


def _unet_state(inputs, lr=LR, **model_kw):
    from audiodenoiser_torch.models.unet import UNet
    from audiodenoiser_torch.train.loop import create_train_state

    state = create_train_state(0, UNet(**NARROW, **model_kw), learning_rate=lr, device="cpu")
    state.model.load_state_dict(inputs["unet_sd"])
    return state


def _step(inputs, tp, fsdp):
    """One fp32 step of the narrow U-Net on an (8, 1, 32, 32) batch."""
    from audiodenoiser_torch.parallel.mesh import shard_batch, shard_train_state
    from audiodenoiser_torch.train.loop import train_step

    mesh = _mesh(model_parallel=tp)
    state = shard_train_state(_unet_state(inputs), mesh, fsdp=fsdp)
    layout = state.layout
    state, losses = train_step(state, shard_batch(inputs["noisy"], mesh),
                               shard_batch(inputs["clean"], mesh))
    out = {"losses": [float(_global(t, mesh)) for t in losses],
           "grad_norm": float(state.grad_norm),
           "running": {k: v.clone() for k, v in state.model.state_dict().items()
                       if "running" in k},
           "coord": mesh.get_coordinate(),
           "full": layout.full_state_dict(state.model)}
    if fsdp:  # the wide kernels' bytes on this rank, against their TP slice's
        wide = {}
        for name, p in state.model.named_parameters():
            if p.dim() == 4 and hasattr(p, "to_local") and p.shape[1 if ".up." not in name
                                                                  else 0] >= 128:
                st = state.optimizer.adamw.state[p]
                wide[name] = (p.to_local().numel(), p.numel(),
                              st["exp_avg"].to_local().numel(),
                              st["exp_avg_sq"].to_local().numel())
        out["wide"] = wide
    return out


def scenario_step_2x2(inputs):
    return _step(inputs, 2, False)


def scenario_fsdp_2x2(inputs):
    return _step(inputs, 2, True)


def scenario_fsdp_4x1(inputs):
    return _step(inputs, 1, True)


def scenario_mesh_shapes(inputs):
    shapes = {"default": tuple(_mesh().shape), "model4": tuple(_mesh(model_parallel=4).shape)}
    one = _mesh(1)
    shapes["one"] = tuple(one.shape)
    try:
        _mesh(model_parallel=3)
    except ValueError as e:
        shapes["error"] = str(e)
    return shapes


def scenario_ragged(inputs, tmp):
    """``fit`` on one ragged batch of 7 (data 2 x model 2): JAX's wrap-pad."""
    from audiodenoiser_torch.models.unet import UNet
    from audiodenoiser_torch.train import loop

    noisy, clean = inputs["noisy"][:7], inputs["clean"][:7]
    cfg = loop.FitConfig(run_name="ragged", output_path=os.path.join(tmp, "fit"), epochs=1,
                         precision="f32", log_every=0, device="cpu", learning_rate=LR,
                         use_mesh=True, model_parallel=2)
    res = loop.fit(cfg, lambda e: iter([(noisy, clean)]), lambda: iter([(noisy, clean)]),
                   state_factory=lambda: _unet_state(inputs))
    return {"history": res["history"],
            "full": res["state"].layout.full_state_dict(res["state"].model)}


def scenario_mask_dp2(inputs):
    """One fp32 mask step on a 2 x 1 mesh of ranks 0-1."""
    from audiodenoiser_torch.models.complex_mask import ComplexMaskUNet
    from audiodenoiser_torch.parallel.mesh import shard_batch, shard_train_state
    from audiodenoiser_torch.train import mask as mask_lib

    mesh = _mesh(2, 1)
    if not _member(mesh):
        return None
    model = ComplexMaskUNet(**NARROW, mask_bound=8.0, residual=True)
    state = mask_lib.create_mask_train_state(0, model, learning_rate=LR, device="cpu")
    state.model.load_state_dict(inputs["mask_sd"])
    state = shard_train_state(state, mesh)
    step, _ = mask_lib.make_mask_steps(0.5, 30.0)
    state, losses = step(state, shard_batch(inputs["mask_noisy"], mesh),
                         shard_batch(inputs["mask_clean"], mesh))
    return {"losses": [float(_global(t, mesh)) for t in losses],
            "grad_norm": float(state.grad_norm),
            "full": state.layout.full_state_dict(state.model)}


def _runner(inputs, tp):
    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.models.unet import UNet

    mesh = _mesh(2, tp)
    if not _member(mesh):
        return None
    model = UNet(**NARROW)
    model.load_state_dict(inputs["runner_sd"])
    runner = DenoiserRunner(model, device="cpu", precision="fft", mesh=mesh)
    sliced = sum(p.shape[0] < q.shape[0] for p, q in zip(runner.model.state_dict().values(),
                                                         inputs["runner_sd"].values())
                 if p.dim())
    out = {"spec": runner.denoise_spectrogram(inputs["mags"]),
           "audio": runner.denoise_audio(inputs["audio"], mode="noisy_phase"),
           "gl": runner.denoise_audio(inputs["audio"], mode="griffin_lim", gl_iters=3),
           "clip": runner.denoise_audio(inputs["audio"][0]), "sliced": int(sliced)}
    if dist.get_rank() == 0:  # the unmeshed runner's Griffin-Lim and unbatched clip
        model = UNet(**NARROW)
        model.load_state_dict(inputs["runner_sd"])
        plain = DenoiserRunner(model, device="cpu", precision="fft")
        out["plain_gl"] = plain.denoise_audio(inputs["audio"], mode="griffin_lim", gl_iters=3)
        out["plain_clip"] = plain.denoise_audio(inputs["audio"][0])
    return out


def scenario_runner_2x1(inputs):
    return _runner(inputs, 1)


def scenario_runner_1x2(inputs):
    return _runner(inputs, 2)


def scenario_init_noop(inputs):
    """The launcher's environment unset, ``maybe_initialize`` changes nothing."""
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    code = ("import torch.distributed as d;"
            "from audiodenoiser_torch.parallel import maybe_initialize as m;"
            "print(m('cpu'), d.is_initialized())")
    if dist.get_rank():
        return None
    return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, check=True).stdout.strip()


def narrow_training(loop) -> None:
    """``fit`` builds the narrow U-Net (as the JAX CLI tests substitute it)."""
    from audiodenoiser_torch.models.unet import UNet

    loop.UNet = lambda dtype, remat=False, **kw: UNet(**NARROW, dtype=dtype, remat=remat)


TRAIN_FLAGS = ["--noise_type", "white", "--batch_size", "4", "--precision", "f32",
               "--num_workers", "1", "--device", "cpu", "--learning_rate", str(LR)]
RESUME_FLAGS = ["--grad_accum", "2", "--ema_decay", "0.5"]


def train_argv(inputs, out, run, *extra):
    return ["--base_dataset_path", inputs["npy_dir"], "--output_path", out,
            "--run_name", run, *TRAIN_FLAGS, *extra]


def scenario_cli_train(inputs, tmp):
    """``cli.train --mesh on --model_parallel 2`` on the two ranks."""
    from audiodenoiser_torch.cli import train as train_cli
    from audiodenoiser_torch.train import loop

    narrow_training(loop)
    res = train_cli.main(train_argv(inputs, os.path.join(tmp, "runs"), "meshed", "--epochs",
                                    "2", "--mesh", "on", "--model_parallel", "2"))
    return {"history": res["history"], "best_path": res["best_path"],
            "sliced": len(res["state"].layout.model_dims)}


def scenario_cli_resume(inputs, tmp):
    """One epoch on 1 x 2, then ``--resume`` onto 2 x 1 with fsdp, with an
    EMA and an accumulated update that spans the two epochs."""
    from audiodenoiser_torch.cli import train as train_cli
    from audiodenoiser_torch.train import loop

    narrow_training(loop)
    out = os.path.join(tmp, "runs")
    first = train_cli.main(train_argv(inputs, out, "resumed", "--epochs", "1", "--mesh", "on",
                                      "--model_parallel", "2", *RESUME_FLAGS))
    second = train_cli.main(train_argv(inputs, out, "resumed", "--epochs", "2", "--mesh", "on",
                                       "--fsdp", "--resume", *RESUME_FLAGS))
    fsdp = sum(hasattr(p, "to_local") for p in second["state"].model.parameters())
    return {"history": first["history"] + second["history"], "fsdp": fsdp,
            "best_path": second["best_path"], "best_ema_path": second["best_ema_path"]}


def scenario_cli_test(inputs, tmp):
    """``cli.test --mesh on --model_parallel 2`` over the test set."""
    from audiodenoiser_torch.cli import test as test_cli

    res = test_cli.main(["--test_data_dir", inputs["test_dir"], "--saved_models_dir",
                         inputs["unet_dir"], "--output_dir", os.path.join(tmp, "test"),
                         "--noise_types", "white", "--num_audio_examples", "1",
                         "--precision", "f32", "--device", "cpu", "--mesh", "on",
                         "--model_parallel", "2"])
    return {"results": res}


SERVE_FLAGS = ["--model", "complex_mask", "--noise_type", "mixed", "--port", "0",
               "--bucket_seconds", "0.25", "--precision", "f32", "--device", "cpu"]


def serve_requests(url, wav: bytes, stream: np.ndarray) -> tuple:
    """One ``/denoise`` answer (WAV bytes) and one stream session's output."""
    import json
    import urllib.request

    def post(path, body=b""):
        req = urllib.request.Request(url + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()

    answer = post("/denoise", wav)
    sid = json.loads(post("/stream/start"))["session"]
    out = post(f"/stream/{sid}", stream.astype("<f4").tobytes()) + post(f"/stream/{sid}/flush")
    return answer, np.frombuffer(out, "<f4").copy()


def scenario_cli_serve(inputs, tmp):
    """``cli.serve --mesh on --model_parallel 2``: rank 0 serves, rank 1
    follows; a request and a stream, ``/admin/reload``, a second request."""
    import threading
    import urllib.request

    from audiodenoiser_torch.cli import serve as serve_cli
    from audiodenoiser_torch.parallel import follow

    argv = SERVE_FLAGS + ["--saved_models_dir", inputs["mask_dir"], "--mesh", "on",
                          "--model_parallel", "2"]
    if dist.get_rank():
        serve_cli.main(argv)  # the follower: returns when rank 0 stops
        follow.uninstall()
        return None
    args = serve_cli.parse_args(argv)
    mesh = serve_cli.build_mesh(args)
    calls = follow.install()
    _, server, _ = serve_cli.build_server(args, mesh)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        first = serve_requests(url, inputs["wav"], inputs["stream"])
        req = urllib.request.Request(url + "/admin/reload", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            reloaded = r.read().decode()
        second = serve_requests(url, inputs["wav"], inputs["stream"])
        runner = server.current_generation()["runner"]
        sliced = len(runner.model.mesh_layout.model_dims)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        calls.stop()
        follow.uninstall()
    return {"first": first, "second": second, "reloaded": reloaded, "sliced": sliced,
            "registered": len(calls.runners)}


def scenario_pp_dp2(inputs):
    """The pipelined forward and one fp32 1F1B step on two data ranks of
    four CPU stages each."""
    from audiodenoiser_torch.parallel.pipeline_train import PipelineTrainer

    trainer = PipelineTrainer(["cpu"] * 4, micro_batch=2, n_micro=3, input_shape=(1, 32, 32),
                              **inputs["pp_widths"], learning_rate=inputs["pp_lr"],
                              data_group=dist.group.WORLD)
    forward = trainer.forward(trainer.init(inputs["pp_sd"]), inputs["pp_noisy"])
    state, loss = trainer.step(trainer.init(inputs["pp_sd"]), inputs["pp_noisy"],
                               inputs["pp_clean"])
    return {"loss": float(loss), "state": trainer.unpack_state(state), "forward": forward}


def _seq_model(inputs):
    from audiodenoiser_torch.models.unet import UNet

    model = UNet(**inputs["seq_widths"]).eval()
    model.load_state_dict(inputs["seq_sd"])
    return model


def _seq(inputs, n):
    from audiodenoiser_torch.parallel.spatial import (
        denoise_spec_sharded,
        denoise_waveform_sharded,
        make_seq_mesh,
    )

    mesh = make_seq_mesh(n, device="cpu")
    if not _member(mesh):
        return None
    model = _seq_model(inputs)
    return {"clip": denoise_spec_sharded(model, inputs["seq_clip"], mesh, halo=96),
            "batch": denoise_spec_sharded(model, inputs["seq_batch"], mesh, halo=16),
            "wave": denoise_waveform_sharded(model, inputs["seq_wav"], mesh, halo=96),
            "short": denoise_spec_sharded(model, inputs["seq_clip"][:, :40], mesh, halo=96)}


def scenario_seq4(inputs):
    return _seq(inputs, 4)


def scenario_seq2(inputs):
    return _seq(inputs, 2)


def _mixture(inputs):
    from audiodenoiser_torch.eval.ensemble import MixtureOfDenoisers
    from audiodenoiser_torch.models import NOISE_CLASSES, NoiseClassifier
    from audiodenoiser_torch.models.unet import UNet

    experts = {}
    for nt, sd in zip(NOISE_CLASSES, inputs["ep_experts"]):
        experts[nt] = UNet(**inputs["ep_widths"])
        experts[nt].load_state_dict(sd)
    router = NoiseClassifier(dtype=torch.float32)
    router.load_state_dict(inputs["ep_router"])
    return MixtureOfDenoisers(experts, router, device="cpu")


def scenario_ep(inputs):
    """The dense dispatch on a (1, 4) mesh and the all-to-all one at three
    capacity factors, on given labels (a skewed set that overflows) and on
    the router's."""
    from audiodenoiser_torch.eval.ensemble import make_a2a_mesh, make_ep_mesh

    mix = _mixture(inputs)
    specs, labels, skewed = inputs["ep_specs"], inputs["ep_labels"], inputs["ep_skewed"]
    dense, a2a = make_ep_mesh(device="cpu"), make_a2a_mesh(device="cpu")
    out = {"dense": mix.denoise_ep(specs, dense, labels=labels),
           "dense_routed": mix.denoise_ep(specs, dense),
           "mesh": (tuple(dense.shape), tuple(a2a.shape))}
    for factor in (1.0, 1.5, 4.0):
        for name, lab in (("labels", labels), ("skewed", skewed)):
            stats = {}
            out[f"a2a_{name}_{factor}"] = (mix.denoise_ep_a2a(specs, a2a, factor, labels=lab,
                                                              stats=stats), stats)
    out["a2a_routed"] = mix.denoise_ep_a2a(specs, a2a)
    try:
        make_ep_mesh(6, device="cpu")
    except ValueError as e:
        out["error"] = str(e)
    return out


def scenario_ep_cli(inputs, tmp):
    """``cli.test --auto_route`` with ``--ep auto`` and ``--ep dense`` on the
    four ranks."""
    from audiodenoiser_torch.cli import test as test_cli

    out = {}
    for ep in ("auto", "dense"):
        out[ep] = test_cli.main(["--auto_route", "--saved_models_dir", inputs["ep_saved"],
                                 "--test_data_dir", inputs["ep_npy"], "--output_dir",
                                 os.path.join(tmp, f"ep_{ep}"), "--precision", "f32",
                                 "--noise_types", "white", "urban", "--device", "cpu",
                                 "--ep", ep])
    return out


SUITES = {
    "parallel": ["mesh_shapes", "step_2x2", "fsdp_2x2", "fsdp_4x1", "ragged", "mask_dp2",
                 "runner_2x1", "runner_1x2", "init_noop"],
    "cli": ["cli_train", "cli_resume", "cli_test", "cli_serve"],
    "pp": ["pp_dp2"],
    "seq": ["seq4", "seq2"],
    "ep": ["ep", "ep_cli"],
}


def main(suite: str, rank: int, world: int, port: int, workdir: str) -> int:
    torch.set_num_threads(1)
    # the scalar log's TensorBoard writer runs on its stub: importing
    # TensorFlow would take most of a rank's time
    sys.modules.setdefault("tensorflow", None)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from audiodenoiser_torch.parallel.distributed import maybe_initialize

    maybe_initialize("cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    results = {}
    status = 0
    for name in SUITES[suite]:
        fn = globals()[f"scenario_{name}"]
        t0 = time.perf_counter()
        try:
            takes_tmp = fn.__code__.co_argcount == 2
            results[name] = fn(inputs, workdir) if takes_tmp else fn(inputs)
            print(f"[worker] rank {rank}: {name} in {time.perf_counter() - t0:.1f} s", flush=True)
        except Exception:
            results["error"] = f"{name}: {traceback.format_exc()}"
            status = 1
            break
    torch.save(results, os.path.join(workdir, f"{suite}_r{rank}.pt"))
    if not status:
        dist.destroy_process_group()
    return status


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5]))
