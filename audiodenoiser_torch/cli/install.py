"""CLI: provision the dataset layout (port of ``cli/install.py``).

Obtains the IRMAS training archive (a download, or a local ``--archive``
on a machine without network), flattens every ``.wav`` inside into
``data/train/clean``, moves ``--test_count`` files chosen by
``random.Random(--seed)`` to ``data/test/clean``, and with ``--venv PATH``
creates a virtual environment that sees the host's site-packages and
installs this repository into it editable, without dependencies or build
isolation (no step but the download needs the network). File lists and
bytes are the JAX CLI's for the same archive and seed.

Usage:
  python -m audiodenoiser_torch.cli.install --archive IRMAS-TrainingData.zip
  python -m audiodenoiser_torch.cli.install            # downloads from Zenodo
  python -m audiodenoiser_torch.cli.install --archive ... --venv .venv
"""

from __future__ import annotations

import argparse
import os
import random
import shutil
import zipfile

IRMAS_URL = "https://zenodo.org/record/1290750/files/IRMAS-TrainingData.zip"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Provision the dataset layout")
    p.add_argument("--archive", default=None, help="local IRMAS zip (skips download)")
    p.add_argument("--url", default=IRMAS_URL)
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--test_count", type=int, default=5)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--venv", default=None, metavar="PATH",
                   help="also create a virtual environment at PATH and pip-install this "
                   "repository into it (editable, no dependencies)")
    return p.parse_args(argv)


def provision_venv(venv_path: str, package_dir: str | None = None) -> str:
    """Create a venv over the host's site-packages and install the
    repository editable with ``--no-deps --no-build-isolation``. Returns the
    venv's python."""
    import site
    import subprocess
    import sys
    import sysconfig
    import venv as venv_lib

    venv_lib.EnvBuilder(with_pip=True, system_site_packages=True).create(venv_path)
    py = os.path.join(venv_path, "Scripts" if os.name == "nt" else "bin", "python")
    # from inside a venv, system_site_packages exposes only the base
    # interpreter's site: link the invoking environment's site dirs too
    new_site = sysconfig.get_path("purelib", vars={"base": os.path.abspath(venv_path),
                                                   "platbase": os.path.abspath(venv_path)})
    host_dirs = [d for d in site.getsitepackages() if os.path.isdir(d)]
    if host_dirs and os.path.isdir(new_site):
        with open(os.path.join(new_site, "_host_site.pth"), "w") as f:
            f.write("\n".join(host_dirs) + "\n")
    if package_dir is None:
        package_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    subprocess.run([py, "-m", "pip", "install", "--no-build-isolation", "--no-deps", "-e",
                    package_dir], check=True, stdout=sys.stdout, stderr=sys.stderr)
    return py


def provision(archive: str, data_dir: str, test_count: int = 5,
              seed: int | None = None) -> tuple[int, int]:
    """Unpack and flatten the archive; returns the (train, test) wav counts."""
    train_clean = os.path.join(data_dir, "train", "clean")
    test_clean = os.path.join(data_dir, "test", "clean")
    for d in (train_clean, test_clean, os.path.join(data_dir, "train", "noise"),
              os.path.join(data_dir, "test", "noise")):
        os.makedirs(d, exist_ok=True)
    with zipfile.ZipFile(archive) as zf:
        for name in (n for n in zf.namelist() if n.lower().endswith(".wav")):
            # flattened: the basename alone, every wav in one folder
            with zf.open(name) as src, open(os.path.join(train_clean, os.path.basename(name)),
                                            "wb") as out:
                shutil.copyfileobj(src, out)
    all_train = sorted(f for f in os.listdir(train_clean) if f.lower().endswith(".wav"))
    test_files = random.Random(seed).sample(all_train, min(test_count, len(all_train)))
    for f in test_files:
        shutil.move(os.path.join(train_clean, f), os.path.join(test_clean, f))
    return len(all_train) - len(test_files), len(test_files)


def main(argv=None):
    args = parse_args(argv)
    archive = args.archive
    if archive is None:
        import urllib.request

        archive = os.path.join(args.data_dir, "IRMAS-TrainingData.zip")
        os.makedirs(args.data_dir, exist_ok=True)
        print(f"Downloading {args.url} ...")
        try:
            urllib.request.urlretrieve(args.url, archive)
        except Exception as e:  # machines without network
            raise SystemExit(
                f"download failed ({e}); fetch the archive manually and pass "
                f"--archive /path/to/IRMAS-TrainingData.zip"
            )
    n_train, n_test = provision(archive, args.data_dir, args.test_count, args.seed)
    print(f"Provisioned {n_train} train and {n_test} test clean wavs under "
          f"{args.data_dir}. Place noise wavs in data/{{train,test}}/noise.")
    if args.venv:
        py = provision_venv(args.venv)
        print(f"Virtual environment ready: {py} (package installed)")


if __name__ == "__main__":
    main()
