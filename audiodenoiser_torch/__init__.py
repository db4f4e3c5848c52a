"""audiodenoiser_torch — the PyTorch/CUDA port of ``audiodenoiser_tpu``.

A second package beside the JAX one, ported slice by slice and held
against it by the ``tests/test_torch_*.py`` parity tests. It imports
neither JAX nor any module of ``audiodenoiser_tpu``.

Subpackages
-----------
dsp     STFT / iSTFT (``precision="fft"`` plain torch, ``"kernel"`` CUDA)
ops     hand-written CUDA kernels (``csrc/*.cu``) with their plain versions
models  live-BN U-Net, its BN-folded inference form, Flax weight carry-over
eval    the fused denoise runner and the throughput bench
data    WAV decode/encode and resampling
serve   the HTTP denoise service
cli     ``python -m audiodenoiser_torch.cli.serve``

Every entry point runs on ``torch.device("cuda")`` unless the caller
passes another device; without a GPU it raises instead of falling back.
"""

__version__ = "0.1.0"
