"""The yardstick of the SEMamba configurations: FLOPs and the scan's bytes
worked out from the configuration's shapes, nothing asked of the program.

FLOPs count 2 per multiply-add of every convolution and linear layer of one
forward: MP-SENet's encoder and two decoders by ``mp_counts``'s formulas
(its forward with no conformers), and per TF-Mamba block, for each of its
two halves (time: T frames of each of F' bins; frequency: F' bins of each
frame) and each of the half's two directions, a mixer's tokens through
``in_proj`` (C -> 2 d_inner), the depthwise conv (k taps), ``x_proj``
(d_inner -> dt_rank + 2 d_state), ``dt_proj`` (dt_rank -> d_inner) and
``out_proj`` (d_inner -> C), with the selective scan counted as mamba_ssm
counts it, 9 d_inner d_state a token; then the half's merge (2C -> C).
``torch.utils.flop_counter`` on the reference's forward, with the scan's
term added since it does not see the scan, reads the same
(``benchmark/tests/test_bench_semamba.py``).

Bytes of the conv and the scan together (``ssm_bytes``): what any
implementation of a mixer's x, z -> y must move, x and z (2 d_inner values
a token) read once and y (d_inner values) written once, in the serving
dtype: 1,536 bytes a token in bf16, for every token of every mixer.
"""

from __future__ import annotations

from benchmark import mp_counts
from benchmark.counts import frames
from benchmark.reference.semamba import dims

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def bins(config: dict) -> int:
    """F': the frequency bins the blocks see, after the encoder's stride-2 conv."""
    return (int(config["n_fft"]) // 2 + 1 - 3) // 2 + 1


def mixer_token_flops(config: dict) -> int:
    """FLOPs of one token through one Mamba mixer, the scan included."""
    c, di, s, k, r = dims(config)
    return 2 * (c * 2 * di + di * k + di * (r + 2 * s) + r * di + di * c) + 9 * di * s


def forward_flops(config: dict, t: int) -> int:
    """FLOPs of one forward on one clip of ``t`` frames."""
    c = int(config["dense_channel"])
    shared = mp_counts.forward_flops({**config, "num_tsconformers": 0, "ffn_mult": 0,
                                      "conv_expansion": 0, "conv_kernel": 0}, t)
    tokens = t * bins(config)  # a half's tokens, along either axis
    half = tokens * (2 * mixer_token_flops(config) + 2 * 2 * c * c)
    return shared + int(config["num_tfmamba"]) * 2 * half


def clip_flops(config: dict, samples: int) -> int:
    """FLOPs of the forward on one clip of ``samples``, zero-padded to a hop
    multiple as the runner does."""
    hop = int(config["hop_length"])
    return forward_flops(config, frames(samples + (-samples) % hop, hop))


def mixers(config: dict) -> int:
    """Mamba mixers a forward: two directions of two halves a block."""
    return 4 * int(config["num_tfmamba"])


def mixer_tokens(config: dict, rows: int, samples: int) -> int:
    """Tokens through each mixer for a batch of ``rows`` clips of ``samples``."""
    hop = int(config["hop_length"])
    return rows * frames(samples + (-samples) % hop, hop) * bins(config)


def ssm_bytes(config: dict, rows: int, samples: int) -> int:
    """Bytes the conv and the scan of every mixer must move for one batch
    (module docstring)."""
    _, di, _, _, _ = dims(config)
    per_token = 3 * di * ITEMSIZE[config["serve_dtype"]]
    return mixers(config) * mixer_tokens(config, rows, samples) * per_token
