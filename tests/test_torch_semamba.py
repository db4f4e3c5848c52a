"""SEMamba in the port (``models.semamba``, the conv and scan's plain
versions in ``ops.cuda.ssm``, ``DenoiserRunner`` mode ``mag_pha``, the
loader and ``cli.serve --model semamba``) against the plain float32
reference ``benchmark/reference/semamba.py`` (the benchmark's, which
decides ``correct`` on the card), on the CPU at the published widths:
one clip of 0.5 s at 16 kHz (T = 81 frames, F' = 100 bins) through the
runner, one of 0.25 s (T = 41) elsewhere, seeded weights.

Tolerances. Both sides compute in float32 and differ by rounding alone.
A TF-Mamba half or the whole model: 1e-5 relative L2 (the port's plain
scan sums C h with ``bmm``, the reference with ``einsum``; the merge is a
matmul against ``conv_transpose1d``; ``F.rms_norm`` against the written-out
norm: float32 roundings, about 5e-7 at a half). The waveform through the
runner: 1e-4 relative, as MP-SENet's, since the STFT, the phase's
``atan2`` and the window differ by rounding as there (about 1e-5 read).
The plain conv and scan against the published flip form: 1e-6 of the
largest output (the same operations in another order). The guards show
that leaving out one part of the mathematics misses the waveform tolerance
by far.
"""

import ast
import json
import math
import threading
import urllib.error
import urllib.request
from io import BytesIO
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiodenoiser_torch.eval.runner import (
    DenoiserRunner,
    load_model_for_noise,
    load_model_from_path,
)
from audiodenoiser_torch.models import semamba
from audiodenoiser_torch.ops.cuda import ssm as ssm_ops
from audiodenoiser_torch.utils import profiling
from benchmark.reference import semamba as ref

CONFIG = dict(dense_channel=64, num_tfmamba=4, d_state=16, d_conv=4, expand=4, n_fft=400,
              hop_length=100, win_length=400, sample_rate=16000, compress_factor=0.3, beta=2.0,
              norm_eps=1e-5)
SR, SAMPLES, ROWS = 16000, 8000, 1
TOL = 1e-4        # the waveform through the runner
BLOCK_TOL = 1e-5  # a TF-Mamba half, the whole model


def _speech(seed: int, rows: int = ROWS, samples: int = SAMPLES) -> torch.Tensor:
    """Harmonics of a pitch under a slow envelope, plus white noise at 5 dB."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / SR
    out = []
    for _ in range(rows):
        f0 = rng.uniform(90, 260)
        wave = sum(np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 6)) / h for h in range(1, 6))
        wave *= 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
        noise = rng.standard_normal(samples)
        noise *= np.sqrt(np.mean(wave ** 2) / np.mean(noise ** 2)) / 10 ** 0.25
        out.append(0.2 * (wave + noise))
    return torch.tensor(np.stack(out), dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The scans step through the tokens in many small operations: two
    threads each, so that a worker of a parallel test run does not wait on
    the cores that the other workers hold."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def weights():
    return ref.seeded_weights(CONFIG, torch.Generator().manual_seed(23), "cpu")


@pytest.fixture(scope="module")
def model(weights):
    m = semamba.SEMamba()
    m.load_state_dict(weights, strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def audio():
    return _speech(2)


@pytest.fixture(scope="module")
def want(weights, audio):
    return ref.denoise(weights, CONFIG, audio)


@pytest.fixture(scope="module")
def short():
    """One clip of 0.25 s (T = 41) for the runs that leave a part out."""
    return _speech(4, rows=1, samples=4000)


@pytest.fixture(scope="module")
def want_short(weights, short):
    return ref.denoise(weights, CONFIG, short)


def _rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per-row relative L2 error."""
    dims = tuple(range(1, want.dim()))
    return ((got - want).square().sum(dims) / want.square().sum(dims)).sqrt()


def _angle_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a - b + math.pi, 2 * math.pi) - math.pi


def test_parameter_count_and_names(model):
    assert sum(p.numel() for p in model.parameters()) == 2_258_769
    assert ref.parameter_count(CONFIG) == 2_258_769
    state = model.state_dict()
    layout = ref.weight_layout(CONFIG)
    assert [n for n, _, _ in layout] == list(state)
    assert all(tuple(state[n].shape) == tuple(s) for n, s, _ in layout)
    prefix = "TSMamba.3.freq_mamba.backward_blocks.0."
    assert [k[len(prefix):] for k in state if k.startswith(prefix)] == [
        "mixer.A_log", "mixer.D", "mixer.in_proj.weight", "mixer.conv1d.weight",
        "mixer.conv1d.bias", "mixer.x_proj.weight", "mixer.dt_proj.weight",
        "mixer.dt_proj.bias", "mixer.out_proj.weight", "norm.weight"]
    assert model.config() == CONFIG


def test_the_mamba_parameters_follow_the_published_arithmetic():
    """One mixer 65,280 parameters, a direction with its RMSNorm 65,344, a
    TF-Mamba block 277,888; MP-SENet's encoder and decoders the rest."""
    from audiodenoiser_torch.models.mpsenet import MPSENet

    def count(m):
        return sum(p.numel() for p in m.parameters())

    block = semamba.TFMambaBlock(64, 1e-5)
    assert count(block.time_mamba.forward_blocks[0].mixer) == 65_280
    assert count(block.time_mamba.forward_blocks[0]) == 65_344
    assert count(block) == 277_888
    assert 2_048_849 - 4 * 225_408 + 4 * 277_888 == 2_258_769 == count(semamba.SEMamba())
    assert count(MPSENet().TSConformer[0]) == 225_408


@pytest.mark.parametrize("part", ["time0", "freq0", "time3", "freq3", "forward"])
@torch.no_grad()
def test_half_matches_the_reference(model, weights, part):
    """The first and last blocks' halves on one clip of 41 frames; the
    whole model (every block) on two."""
    gen = torch.Generator().manual_seed(5)
    t, f, rows = 41, 100, 1
    if part == "forward":
        mag = torch.rand(ROWS, 201, t, generator=gen) * 3
        pha = (torch.rand(ROWS, 201, t, generator=gen) * 2 - 1) * math.pi
        (got, g_pha), (exp, e_pha) = model(mag, pha), ref.forward(weights, CONFIG, mag, pha)
        assert float(_angle_gap(g_pha, e_pha).abs().max()) < 1e-3
    else:
        i = int(part[-1])
        block = model.TSMamba[i]
        if part.startswith("time"):
            x = torch.randn(rows * f, t, 64, generator=gen)
            got = semamba._merge(block.tlinear, block.time_mamba(x)) + x
            exp = ref.time_half(weights, i, x, CONFIG)
        else:
            x = torch.randn(rows * t, f, 64, generator=gen)
            got = semamba._merge(block.flinear, block.freq_mamba(x)) + x
            exp = ref.freq_half(weights, i, x, CONFIG)
    assert got.shape == exp.shape
    assert float(_rel(got, exp).max()) < BLOCK_TOL


@torch.no_grad()
def test_the_block_permutes_as_the_reference(model, weights):
    """A whole TF-Mamba block over (B, C, T, F'): both halves and the
    permutes between them."""
    x = torch.randn(1, 64, 41, 100, generator=torch.Generator().manual_seed(6))
    got, exp = model.TSMamba[2](x), ref.tf_block(weights, 2, x, CONFIG)
    assert got.shape == exp.shape == x.shape
    assert float(_rel(got, exp).max()) < BLOCK_TOL


def _mixer_case(seed: int, n: int = 5, length: int = 37, d: int = 64):
    """xz, the conv's parameters and the scan's, at mamba_ssm's initial
    distributions (``ref.seeded_weights``'s), with x_dbl from a seeded
    x_proj of u."""
    gen = torch.Generator().manual_seed(seed)
    xz = torch.randn(n, length, 2 * d, generator=gen)
    w = torch.randn(d, 1, 4, generator=gen) * math.sqrt(0.5)
    b = 0.1 * torch.randn(d, generator=gen)
    x_proj = torch.randn(36, d, generator=gen) * math.sqrt(2 / d)
    dt_w = (torch.rand(d, 4, generator=gen) * 2 - 1) * 0.5
    dt = torch.exp(torch.rand(d, generator=gen) * math.log(100.0) + math.log(1e-3))
    dt_b = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(torch.arange(1, 17.0)).repeat(d, 1) + 0.1 * torch.randn(d, 16, generator=gen)
    d_skip = 1 + 0.1 * torch.randn(d, generator=gen)
    return xz, (w, b), x_proj, (dt_w, dt_b, a_log, d_skip)


def _flip_form(xz, conv, x_proj, scan):
    """The published backward direction: the causal conv and the scan
    (``ref.selective_scan``) of the flipped sequence, flipped back."""
    d = xz.shape[-1] // 2
    xf = xz.flip(1)
    u = F.silu(F.conv1d(xf[..., :d].transpose(1, 2), conv[0], conv[1], padding=3,
                        groups=d)[..., :xz.shape[1]]).transpose(1, 2)
    dt, b, c = F.linear(u, x_proj).split([4, 16, 16], dim=-1)
    dt_w, dt_b, a_log, d_skip = scan
    delta = F.softplus(F.linear(dt, dt_w, dt_b))
    y = ref.selective_scan(u, delta, -torch.exp(a_log), b, c, d_skip, xf[..., d:])
    return u.flip(1), y.flip(1)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_plain_conv_and_scan_match_the_flip_form(reverse):
    """The plain entries, the backward direction by ``reverse`` on the
    unflipped sequence, against the published form: the forward direction
    as it is, the backward one flipped, run and flipped back."""
    xz, conv, x_proj, scan = _mixer_case(11)
    if reverse:
        want_u, want_y = _flip_form(xz, conv, x_proj, scan)
    else:
        want_u, want_y = _flip_form(xz.flip(1), conv, x_proj, scan)
        want_u, want_y = want_u.flip(1), want_y.flip(1)
    with torch.no_grad():
        u = ssm_ops.ssm_conv(xz, *conv, reverse=reverse)
        y = ssm_ops.ssm_scan(u, xz, F.linear(u, x_proj), *scan, reverse=reverse)
    assert float((u - want_u).abs().max() / want_u.abs().max()) < 1e-6
    assert float((y - want_y).abs().max() / want_y.abs().max()) < 1e-6
    # the two directions differ: reverse is no relabelling of the forward scan
    other = ssm_ops.ssm_conv(xz, *conv, reverse=not reverse)
    assert float((other - want_u).abs().max() / want_u.abs().max()) > 0.1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_entries_round_once(dtype):
    """The plain entries compute in float32 and round once: in bf16 they
    are the float32 result of the bf16 inputs, rounded."""
    xz, conv, x_proj, scan = _mixer_case(12)
    xz, conv, scan = xz.to(dtype), tuple(t.to(dtype) for t in conv), tuple(t.to(dtype)
                                                                             for t in scan)
    u = ssm_ops.ssm_conv_plain(xz, *conv)
    assert u.dtype == dtype and u.is_contiguous()
    u32 = ssm_ops.ssm_conv_plain(xz.float(), *(t.float() for t in conv))
    assert torch.equal(u, u32.to(dtype))
    x_dbl = F.linear(u, x_proj.to(dtype))
    y = ssm_ops.ssm_scan_plain(u, xz, x_dbl, *scan)
    y32 = ssm_ops.ssm_scan_plain(u.float(), xz.float(), x_dbl.float(), *(t.float() for t in scan))
    assert y.dtype == dtype and torch.equal(y, y32.to(dtype))


def test_entries_refuse_shapes_they_do_not_take():
    xz, conv, x_proj, scan = _mixer_case(13)
    u = ssm_ops.ssm_conv(xz, *conv)
    x_dbl = F.linear(u, x_proj)
    with pytest.raises(ValueError):
        ssm_ops.ssm_conv(xz[..., :-1], *conv)
    with pytest.raises(ValueError):
        ssm_ops.ssm_conv(xz, conv[0][:32], conv[1])
    with pytest.raises(ValueError):
        ssm_ops.ssm_scan(u, xz, x_dbl[..., :-1], *scan)
    with pytest.raises(ValueError):
        ssm_ops.ssm_scan(u, xz[:, :-1], x_dbl, *scan)
    with pytest.raises(ValueError):
        ssm_ops.ssm_scan(u, xz, x_dbl, scan[0], scan[1], scan[2][:, :8], scan[3])


def _runner_error(model, audio, want) -> float:
    got = DenoiserRunner(model, device="cpu").denoise_audio(audio)
    assert got.shape == want.shape
    return float(_rel(got, want).max())


def test_runner_matches_the_reference(model, audio, want):
    runner = DenoiserRunner(model, device="cpu")
    assert (runner.mode, runner.n_fft, runner.hop) == ("mag_pha", 400, 100)
    assert _runner_error(model, audio, want) < TOL
    # a clip that is no hop multiple is padded and cut back as the reference does
    assert _runner_error(model, audio[:, :3950],
                         ref.denoise(model.state_dict(), CONFIG, audio[:, :3950])) < TOL


def test_runner_refusals_name_the_model(model):
    with pytest.raises(ValueError, match="SEMamba runs at n_fft=400"):
        DenoiserRunner(model, n_fft=512, device="cpu")
    runner = DenoiserRunner(model, device="cpu")
    with pytest.raises(NotImplementedError, match="mag_pha"):
        runner.denoise_audio(torch.zeros(1, 800), mode="noisy_phase")


def _scan_without(part):
    """The scan entry with one part of its mathematics left out."""

    def scan(u, xz, x_dbl, dt_w, dt_b, a_log, d_skip, reverse=False):
        if part == "d_skip":
            return ssm_ops.ssm_scan(u, xz, x_dbl, dt_w, dt_b, a_log, torch.zeros_like(d_skip),
                                    reverse)
        d = u.shape[-1]
        dt, b, c = x_dbl.split([4, 16, 16], dim=-1)
        delta = F.linear(dt, dt_w, dt_b)
        delta = delta if part == "softplus" else F.softplus(delta)
        order = (lambda t: t.flip(1)) if reverse else (lambda t: t)
        z = xz[..., d:] if part != "z_gate" else torch.full_like(u, 30.0)  # silu(30) ~ 30
        y = ref.selective_scan(order(u), order(delta), -torch.exp(a_log), order(b), order(c),
                               d_skip, order(z))
        return order(y) / (30.0 if part == "z_gate" else 1.0)

    return scan


def _no_backward_direction(self, x):
    """Both halves of a bidirectional block run forward in time."""
    y_fwd, y_bwd = x, x
    for layer in self.forward_blocks:
        y_fwd = layer(y_fwd)
    for layer in self.backward_blocks:
        y_bwd = layer(y_bwd)
    return torch.cat([y_fwd, y_bwd], dim=-1)


@pytest.mark.parametrize("part", ["none", "d_skip", "z_gate", "softplus", "backward"])
def test_leaving_out_a_part_misses_the_tolerance(model, short, want_short, monkeypatch, part):
    """Each part of the mixer's mathematics moves the answer past the
    tolerance by far; the harness of the faults, with nothing left out,
    meets it."""
    if part == "backward":
        monkeypatch.setattr(semamba.MambaBlock, "forward", _no_backward_direction)
    else:
        monkeypatch.setattr(semamba, "ssm_scan", _scan_without(part))
    err = _runner_error(model, short, want_short)
    if part == "none":
        assert err < TOL
    else:  # a NaN (the raw dt_proj output, negative, makes the states grow) misses it too
        assert not err <= 10 * TOL


@torch.no_grad()
def test_cpu_forward_takes_the_plain_conv_and_scan_16_times_each(model, monkeypatch):
    from audiodenoiser_torch.ops.cuda import reset_launch_counts, ssm_kernel, variant_launches

    calls = {"conv": 0, "scan": 0}
    for entry in ("conv", "scan"):
        plain = getattr(ssm_ops, f"ssm_{entry}_plain")

        def counted(*args, _plain=plain, _entry=entry, **kw):
            calls[_entry] += 1
            return _plain(*args, **kw)

        monkeypatch.setattr(ssm_ops, f"ssm_{entry}_plain", counted)
    gen = torch.Generator().manual_seed(3)
    mag, pha = torch.rand(1, 201, 4, generator=gen), torch.rand(1, 201, 4, generator=gen)
    reset_launch_counts()
    model(mag, pha)
    assert calls == {"conv": 16, "scan": 16}
    assert ssm_kernel.launches == 32
    assert variant_launches(ssm_kernel) == {"kernel": 0, "plain": 32}


def test_spans_cover_the_forward(model, audio):
    from torch.profiler import ProfilerActivity, profile

    runner = DenoiserRunner(model, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.denoise_audio(audio[:, :1600])
    names = [e.name for e in prof.events() if e.name.startswith("adt.")]
    mine = [n for n in names if n.startswith(("adt.sm.", "adt.mp."))]
    assert {n: mine.count(n) for n in set(mine)} == {
        profiling.MP_ENCODER: 1, profiling.MP_DECODERS: 1,
        profiling.SM_TIME: 4, profiling.SM_TIME_MIXER: 8,
        profiling.SM_FREQ: 4, profiling.SM_FREQ_MIXER: 8}
    events = {n: [e for e in prof.events() if e.name == n] for n in set(names)}
    (model_span,) = events[profiling.MODEL]
    for n in set(mine):
        for e in events[n]:
            assert model_span.time_range.start <= e.time_range.start
            assert e.time_range.end <= model_span.time_range.end
    for inner, outer in ((profiling.SM_TIME_MIXER, profiling.SM_TIME),
                         (profiling.SM_FREQ_MIXER, profiling.SM_FREQ)):
        for e in events[inner]:
            assert any(o.time_range.start <= e.time_range.start
                       and e.time_range.end <= o.time_range.end for o in events[outer])


def _save(model, folder: Path, wrapped: bool) -> Path:
    path = folder / "semamba_white.pth"
    state = model.state_dict()
    torch.save({"generator": state} if wrapped else state, path)
    (folder / "semamba_white.json").write_text(json.dumps({"model": "semamba",
                                                           **model.config()}))
    return path


@pytest.mark.parametrize("wrapped", [False, True], ids=["plain", "generator"])
def test_loader_round_trip(model, tmp_path, wrapped):
    loaded = load_model_from_path(str(_save(model, tmp_path, wrapped)), dtype=torch.float32,
                                  device="cpu")
    assert isinstance(loaded, semamba.SEMamba) and not loaded.training
    assert loaded.config() == model.config()
    mine, theirs = model.state_dict(), loaded.state_dict()
    assert list(mine) == list(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in mine)
    bf16 = load_model_for_noise("white", str(tmp_path), device="cpu", stem="semamba")
    assert isinstance(bf16, semamba.SEMamba) and bf16.dtype == torch.bfloat16


def test_serve_answers_a_request(model, audio, tmp_path):
    from scipy.io import wavfile

    from audiodenoiser_torch.cli import serve

    _save(model, tmp_path, wrapped=True)
    args = serve.parse_args(["--model", "semamba", "--saved_models_dir", str(tmp_path),
                             "--device", "cpu", "--precision", "f32", "--no_warmup",
                             "--port", "0", "--bucket_seconds", "0.25"])
    assert args.mode == "mag_pha" and args.sample_rate is None
    service, server, name = serve.build_server(args)
    assert (name, args.sample_rate, service.sample_rate) == ("semamba_white", 16000, 16000)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        clip = (audio[0, :3000].numpy() * 32767).astype(np.int16)
        buf = BytesIO()
        wavfile.write(buf, SR, clip)
        req = urllib.request.Request(f"{url}/denoise", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            sr, out = wavfile.read(BytesIO(r.read()))
        assert sr == SR and len(out) == 3000
        # what the service saw: the int16 clip zero-padded to its 0.25 s bucket
        seen = torch.from_numpy(np.pad(clip / 32768.0, (0, 1000)).astype(np.float32))
        direct = DenoiserRunner(model, device="cpu").denoise_audio(seen[None])[0, :3000]
        want = np.clip(direct.numpy() * 32768, -32768, 32767)
        assert np.abs(out.astype(np.float64) - want).max() <= 2.0
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(f"{url}/stream/start", data=b"",
                                                          method="POST"), timeout=30)
        assert e.value.code == 501
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("extra", [["--stream_pool", "4"], ["--auto_route"],
                                   ["--stream_latency_ms", "100"]])
def test_serve_refuses_streams_and_routing(extra):
    from audiodenoiser_torch.cli import serve

    with pytest.raises(SystemExit, match="--model semamba is offline"):
        serve.parse_args(["--model", "semamba", *extra])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rms_norm_is_f_rms_norm_in_float32(dtype):
    """The port's RMSNorm is ``F.rms_norm`` in float32 rounded once, and
    the reference's written-out norm in float32."""
    gen = torch.Generator().manual_seed(7)
    x = (3 * torch.randn(6, 5, 64, generator=gen)).to(dtype)
    norm = semamba.RMSNorm(64)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(64, generator=gen))
    norm = norm.to(dtype)
    with torch.no_grad():
        got = norm(x)
        want = ref.rms_norm(x.float(), norm.weight.float())
    assert got.dtype == dtype
    # float32: the two orders of the same operations; bf16: both round one
    # float32 value, within one bf16 ulp (2**-7 of the value at most)
    gap = (got.float() - want).abs() / want.abs().clamp_min(1e-30)
    assert float(gap.max()) < (1e-6 if dtype == torch.float32 else 2 ** -7)


def test_the_reference_imports_nothing_but_torch_and_the_mpsenet_reference():
    """The reference stands apart from the program: no module of the port,
    of JAX or of the JAX package is imported, at its top level or inside a
    function; the shared parts come from the MP-SENet reference, the TF32
    switch from the reference package."""
    tree = ast.parse(Path(ref.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.update(f"{node.module}.{a.name}" for a in node.names)
    assert names <= {"__future__.annotations", "math", "torch", "torch.nn.functional",
                     "benchmark.reference.mpsenet", "benchmark.reference.exact_float32"}, names


def test_seeded_scan_parameters_follow_mamba_ssm_initialisation(weights):
    """``A_log`` near log(1..16), ``D`` near 1, dt_proj's weights within
    +-1/2 and its bias the inverse softplus of steps in [1e-3, 1e-1]."""
    prefix = "TSMamba.1.time_mamba.forward_blocks.0.mixer."
    a_log = weights[prefix + "A_log"]
    assert float((a_log - torch.log(torch.arange(1, 17.0))).std()) == pytest.approx(0.1, rel=0.1)
    assert float(weights[prefix + "D"].mean()) == pytest.approx(1.0, abs=0.05)
    assert float(weights[prefix + "dt_proj.weight"].abs().max()) <= 0.5
    dt = F.softplus(weights[prefix + "dt_proj.bias"])
    assert 1e-3 * (1 - 1e-5) <= float(dt.min()) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
