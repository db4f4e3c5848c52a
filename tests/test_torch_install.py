"""The port's provisioning CLI (``cli/install.py``) against the JAX
package's on a synthetic archive built in ``tmp_path``: the same train and
test file lists and bytes for each seed and test count. Neither the
download nor ``--venv`` runs here: the download's failure path is driven
with ``urlretrieve`` replaced, and ``provision_venv`` with the venv
builder and pip replaced, so nothing leaves the machine."""

import os
import zipfile

import numpy as np
import pytest

from audiodenoiser_torch.cli import install as port_install
from audiodenoiser_torch.data.wav_io import write_wav
from audiodenoiser_tpu.cli import install as jax_install


def _archive(tmp_path, n=9):
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(0)
    path = tmp_path / "IRMAS-TrainingData.zip"
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(n):
            wav = src / f"clip_{i}.wav"
            write_wav(str(wav), rng.standard_normal(2000) * 0.1, 8000)
            zf.write(wav, arcname=f"IRMAS-TrainingData/ins{i % 3}/clip_{i}.wav")
        zf.writestr("IRMAS-TrainingData/README.txt", "not audio")
    return str(path)


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


@pytest.mark.parametrize("seed,count", [(0, 3), (1, 5), (7, 0), (3, 20)])
def test_provision_matches_jax(tmp_path, seed, count):
    archive = _archive(tmp_path)
    ours = port_install.provision(archive, str(tmp_path / "port"), count, seed)
    ref = jax_install.provision(archive, str(tmp_path / "jax"), count, seed)
    assert ours == ref
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert len(os.listdir(tmp_path / "port" / "test" / "clean")) == min(count, 9)
    assert os.path.isdir(tmp_path / "port" / "test" / "noise")


def test_cli_with_a_local_archive_prints_jax_lines(tmp_path, capsys):
    archive = _archive(tmp_path)
    jax_install.main(["--archive", archive, "--data_dir", str(tmp_path / "j"), "--seed", "2"])
    ref = capsys.readouterr().out.replace(str(tmp_path / "j"), "D")
    port_install.main(["--archive", archive, "--data_dir", str(tmp_path / "p"), "--seed", "2"])
    assert capsys.readouterr().out.replace(str(tmp_path / "p"), "D") == ref
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")


def test_failed_download_gives_jax_message(tmp_path, monkeypatch):
    import urllib.request

    def refuse(url, path):
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    argv = ["--data_dir", str(tmp_path / "d")]
    with pytest.raises(SystemExit) as ref:
        jax_install.main(argv)
    with pytest.raises(SystemExit) as ours:
        port_install.main(argv)
    assert str(ours.value) == str(ref.value)
    assert "--archive /path/to/IRMAS-TrainingData.zip" in str(ours.value)


def test_venv_installs_the_repository_editable_without_deps(tmp_path, monkeypatch):
    import subprocess
    import venv

    calls = []
    monkeypatch.setattr(venv.EnvBuilder, "create", lambda self, path: os.makedirs(path))
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append(cmd))
    py = port_install.provision_venv(str(tmp_path / "venv"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(port_install.__file__)))
    root = os.path.dirname(root)
    assert py == os.path.join(str(tmp_path / "venv"), "bin", "python")
    assert calls == [[py, "-m", "pip", "install", "--no-build-isolation", "--no-deps", "-e",
                      root]]
