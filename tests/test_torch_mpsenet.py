"""MP-SENet in the port (``models.mpsenet``, ``DenoiserRunner`` mode
``mag_pha``, the loader and ``cli.serve --model mpsenet``) against the plain
float32 reference ``benchmark/reference/mpsenet.py`` (the benchmark's,
which decides ``correct`` on the card), on the CPU at the
published widths: batch 2, 0.5 s at 16 kHz (T = 81 frames).

The waveform tolerance is 1e-4 relative. Both sides compute in float32;
they differ by rounding alone: the port's Hann window (numpy) against
``torch.hann_window``, its framed ``rfft`` against ``torch.stft``,
``scaled_dot_product_attention`` against the written-out softmax, and
``atan2`` in the phase decoder, which scales a rounding of (r, i) by
1 / |(r, i)|. The guards show that leaving out one part of the
mathematics misses that tolerance by far.
"""

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

from audiodenoiser_torch.eval.runner import DenoiserRunner, load_model_from_path
from audiodenoiser_torch.models import mpsenet
from audiodenoiser_torch.utils import profiling
from benchmark.reference import mpsenet as ref

CONFIG = dict(dense_channel=64, num_tsconformers=4, n_fft=400, hop_length=100,
              win_length=400, sample_rate=16000, compress_factor=0.3, beta=2.0, n_head=4,
              conv_kernel=31, ffn_mult=4, conv_expansion=2)
SR, SAMPLES, ROWS = 16000, 8000, 2
TOL = 1e-4


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


@pytest.fixture(scope="module")
def weights():
    p = ref.seeded_weights(CONFIG, torch.Generator().manual_seed(19), "cpu")
    ref.calibrate(p, CONFIG, _speech(1))
    return p


@pytest.fixture(scope="module")
def model(weights):
    m = mpsenet.MPSENet()
    m.load_state_dict(weights, strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def audio():
    return _speech(2)


@pytest.fixture(scope="module")
def want(weights, audio):
    return ref.denoise(weights, CONFIG, audio)


def _rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per-row relative L2 error."""
    dims = tuple(range(1, want.dim()))
    return ((got - want).square().sum(dims) / want.square().sum(dims)).sqrt()


def _angle_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a - b + math.pi, 2 * math.pi) - math.pi


def test_parameter_count_and_names(model):
    assert sum(p.numel() for p in model.parameters()) == 2_048_849
    assert ref.parameter_count(CONFIG) == 2_048_849
    state = model.state_dict()
    layout = ref.weight_layout(CONFIG)
    assert [n for n, _, _ in layout] == list(state)
    assert all(tuple(state[n].shape) == tuple(s) for n, s, _ in layout)
    # the defaults are the published config.json's
    assert model.config() == {k: CONFIG[k] for k in (
        "dense_channel", "num_tsconformers", "n_fft", "hop_length", "win_length",
        "sample_rate", "compress_factor", "beta")}


@pytest.mark.parametrize("block", ["encoder", "ts0", "ts1", "ts2", "ts3", "mask", "phase",
                                   "forward"])
@torch.no_grad()
def test_block_matches_the_reference(model, weights, block):
    gen = torch.Generator().manual_seed(5)
    t = 81
    x = torch.randn(ROWS, 64, t, 100, generator=gen)
    if block == "encoder":
        inp = torch.randn(ROWS, 2, t, 201, generator=gen)
        got, exp = model.dense_encoder(inp), ref.dense_encoder(weights, inp)
    elif block.startswith("ts"):
        i = int(block[2:])
        got, exp = model.TSConformer[i](x), ref.ts_block(weights, i, x, CONFIG)
    elif block == "mask":
        got, exp = model.mask_decoder(x), ref.mask_decoder(weights, x, CONFIG)
    elif block == "phase":
        got, exp = model.phase_decoder(x), ref.phase_decoder(weights, x)
        assert float(_angle_gap(got, exp).abs().max()) < 1e-3
        return
    else:
        mag = torch.rand(ROWS, 201, t, generator=gen) * 3
        pha = (torch.rand(ROWS, 201, t, generator=gen) * 2 - 1) * math.pi
        (got, g_pha), (exp, e_pha) = model(mag, pha), ref.forward(weights, CONFIG, mag, pha)
        assert float(_angle_gap(g_pha, e_pha).abs().max()) < 1e-3
    assert got.shape == exp.shape
    assert float(_rel(got, exp).max()) < 1e-5


def _runner_error(model, audio, want) -> float:
    got = DenoiserRunner(model, device="cpu").denoise_audio(audio)
    assert got.shape == want.shape
    return float(_rel(got, want).max())


def test_runner_matches_the_reference(model, audio, want):
    runner = DenoiserRunner(model, device="cpu")
    assert (runner.mode, runner.n_fft, runner.hop) == ("mag_pha", 400, 100)
    assert _runner_error(model, audio, want) < TOL
    # a clip that is no hop multiple is padded and cut back as the reference does
    assert _runner_error(model, audio[:, :7950], ref.denoise(model.state_dict(), CONFIG,
                                                             audio[:, :7950])) < TOL


def _no_batchnorm(self, x):
    ln, pw1, dw, _, pw2 = (self.ccm[i] for i in (0, 2, 4, 5, 7))
    y = F.glu(F.linear(ln(x), pw1.weight[..., 0], pw1.bias), dim=-1)
    y = F.silu(dw(y.transpose(1, 2)))
    return F.linear(y.transpose(1, 2), pw2.weight[..., 0], pw2.bias)


def _no_ts_residual(self, x):
    b, c, t, f = x.shape
    x = self.time_conformer(x.permute(0, 3, 2, 1).reshape(b * f, t, c))
    x = x.view(b, f, t, c).permute(0, 2, 1, 3).reshape(b * t, f, c)
    x = self.freq_conformer(x)
    return x.view(b, t, f, c).permute(0, 3, 1, 2)


def _unscaled_attention(self, x):
    n, length, dim = x.shape
    qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
    q, k, v = qkv.view(n, length, 3, self.n_head, dim // self.n_head).permute(2, 0, 3, 1, 4)
    y = F.scaled_dot_product_attention(q, k, v, scale=1.0)
    return self.out_proj(y.transpose(1, 2).reshape(n, length, dim))


@pytest.mark.parametrize("cls,fault", [
    ("ConformerConvModule", _no_batchnorm),
    ("TSConformerBlock", _no_ts_residual),
    ("MultiheadAttention", _unscaled_attention),
], ids=["conv_module_batchnorm", "ts_residual", "attention_scale"])
def test_leaving_out_a_part_misses_the_tolerance(model, audio, want, monkeypatch, cls, fault):
    monkeypatch.setattr(getattr(mpsenet, cls), "forward", fault)
    assert _runner_error(model, audio, want) > 10 * TOL


def _save(model, folder: Path, wrapped: bool) -> Path:
    path = folder / "mpsenet_white.pth"
    state = model.state_dict()
    torch.save({"generator": state} if wrapped else state, path)
    (folder / "mpsenet_white.json").write_text(json.dumps({"model": "mpsenet",
                                                           **model.config()}))
    return path


@pytest.mark.parametrize("wrapped", [False, True], ids=["plain", "generator"])
def test_loader_round_trip(model, tmp_path, wrapped):
    loaded = load_model_from_path(str(_save(model, tmp_path, wrapped)), dtype=torch.float32,
                                  device="cpu")
    assert isinstance(loaded, mpsenet.MPSENet) and not loaded.training
    assert loaded.config() == model.config()
    mine, theirs = model.state_dict(), loaded.state_dict()
    assert list(mine) == list(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in mine)
    bf16 = load_model_from_path(str(tmp_path / "mpsenet_white.pth"), device="cpu")
    assert bf16.dtype == torch.bfloat16


def test_serve_answers_a_request(model, audio, tmp_path):
    from scipy.io import wavfile

    from audiodenoiser_torch.cli import serve

    _save(model, tmp_path, wrapped=True)
    args = serve.parse_args(["--model", "mpsenet", "--saved_models_dir", str(tmp_path),
                             "--device", "cpu", "--precision", "f32", "--no_warmup",
                             "--port", "0", "--bucket_seconds", "0.5"])
    assert args.mode == "mag_pha" and args.sample_rate is None
    service, server, name = serve.build_server(args)
    assert (name, args.sample_rate, service.sample_rate) == ("mpsenet_white", 16000, 16000)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        clip = (audio[0, :6000].numpy() * 32767).astype(np.int16)
        buf = BytesIO()
        wavfile.write(buf, SR, clip)
        req = urllib.request.Request(f"{url}/denoise", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            sr, out = wavfile.read(BytesIO(r.read()))
        assert sr == SR and len(out) == 6000
        # what the service saw: the int16 clip zero-padded to its 0.5 s bucket
        seen = torch.from_numpy(np.pad(clip / 32768.0, (0, 2000)).astype(np.float32))
        direct = DenoiserRunner(model, device="cpu").denoise_audio(seen[None])[0, :6000]
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
    with pytest.raises(SystemExit):
        serve.parse_args(["--model", "mpsenet", "--stream_pool", "4"])


def test_spans_cover_the_forward(model, audio):
    from torch.profiler import ProfilerActivity, profile

    runner = DenoiserRunner(model, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.denoise_audio(audio)
    names = [e.name for e in prof.events() if e.name.startswith("adt.")]
    mine = [n for n in names if n.startswith("adt.mp.")]
    assert {n: mine.count(n) for n in set(mine)} == {
        profiling.MP_ENCODER: 1, profiling.MP_DECODERS: 1,
        profiling.MP_TIME: 4, profiling.MP_TIME_ATTENTION: 4,
        profiling.MP_FREQ: 4, profiling.MP_FREQ_ATTENTION: 4}
    events = {n: [e for e in prof.events() if e.name == n] for n in set(names)}
    (model_span,) = events[profiling.MODEL]
    for n in set(mine):
        for e in events[n]:
            assert model_span.time_range.start <= e.time_range.start
            assert e.time_range.end <= model_span.time_range.end
    for inner, outer in ((profiling.MP_TIME_ATTENTION, profiling.MP_TIME),
                         (profiling.MP_FREQ_ATTENTION, profiling.MP_FREQ)):
        for e in events[inner]:
            assert any(o.time_range.start <= e.time_range.start
                       and e.time_range.end <= o.time_range.end for o in events[outer])



def test_the_reference_imports_nothing_but_torch():
    """The one reference, which the benchmark's check also uses, stands
    apart from the program: no module of the port, of JAX or of the JAX
    package is imported at its top level or inside a function."""
    import ast

    tree = ast.parse(Path(ref.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert {n.split(".")[0] for n in names} <= {"__future__", "math", "torch"}, names
