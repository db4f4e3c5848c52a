"""audiodenoiser_torch — the PyTorch/CUDA port of ``audiodenoiser_tpu``.

A second package beside the JAX one, ported slice by slice and held
against it by the ``tests/test_torch_*.py`` parity tests. It imports
neither JAX nor any module of ``audiodenoiser_tpu``.

Subpackages
-----------
dsp     STFT / iSTFT (``precision="fft"`` plain torch, ``"kernel"`` CUDA),
        mel spectrogram, the four noise corruptions
ops     hand-written CUDA kernels (``csrc/*.cu``) with their plain versions
models  live-BN U-Net (bf16, K3 deconv), its BN-folded inference form,
        Flax weight carry-over
losses  the combined 0.4/0.4/0.2 spectral training loss
train   clipped AdamW, train/eval steps, ``fit``, exports and logs
eval    the fused denoise runner and the throughput bench
data    WAV IO, chunking, the ``.npy`` dataset, the on-device mixer
serve   the HTTP denoise service
utils   tracing, timing and the finiteness guard
cli     ``python -m audiodenoiser_torch.cli.{train,serve,test,bench,...}``

Every entry point runs on ``torch.device("cuda")`` unless the caller
passes another device; without a GPU it raises instead of falling back.
"""

__version__ = "0.1.0"

# the JAX package's constants, the port's own copy
SAMPLE_RATE = 8000
N_FFT = 512
HOP_LENGTH = 128
CHUNK_SECONDS = 2.0
CHUNK_SAMPLES = int(SAMPLE_RATE * CHUNK_SECONDS)
SNR_DB = 8.0
NOISE_TYPES = ("white", "urban", "reverb", "noise_cancellation")
TARGET_SIZE = (256, 64)
