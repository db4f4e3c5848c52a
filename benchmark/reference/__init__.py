"""The plain reference that decides ``correct``: float32 PyTorch, TF32 off,
``torch.stft``/``torch.istft``, live BatchNorm. It imports nothing of the
program and nothing of JAX, and takes nothing the program made: it is
handed the benchmark's own weights, audio and draws, and works out the
padding, the features, the mask, the mixer's corruptions, the losses, the
clip and AdamW again from them.

The training control, one precision below the bfloat16 the configuration
trains in (float32 accumulation): ``precision="int8"`` rounds every
convolution's input to symmetric int8 under one scale a tensor and its
kernel under one scale an output channel, as the program's own int8
compute does. The serving control is the program's own int8 compute.
"""

import contextlib

import torch


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
