"""The yardstick of the MP-SENet configurations: FLOPs worked out from the
configuration's shapes, nothing asked of the program.

FLOPs count 2 per multiply-add of every convolution, linear layer and
attention product of one forward: the encoder's 1x1 conv, its dense block
(layer i takes 64(i+1) channels through a 3x3 kernel) at F bins and its
(1, 3) stride-2 conv to F' = (F - 3) // 2 + 1; per conformer and token the
two FFNs, the attention's in- and out-projections, QK^T and AV over the
sequence (time: T frames of each of F' bins; frequency: F' bins of each
frame) and the conv module's pointwise, depthwise and pointwise convs; the
two decoders' dense blocks at F', transposed convs back to F and 1x1
heads. ``torch.utils.flop_counter`` on the reference's forward reads the
same: 167,884,258,962 at T = 321 and 356,249,802,002 at T = 641.
"""

from __future__ import annotations

from benchmark.counts import frames


def _dense_block(c: int, depth: int, t: int, f: int) -> int:
    return sum(2 * c * (i + 1) * c * 9 * t * f for i in range(depth))


def _conformer_token(config: dict) -> int:
    """FLOPs a token of one conformer, the attention products left out."""
    c = int(config["dense_channel"])
    hid, inner = c * int(config["ffn_mult"]), c * int(config["conv_expansion"])
    ffns = 2 * 2 * (c * hid + hid * c)
    projections = 2 * c * 3 * c + 2 * c * c
    conv = 2 * c * 2 * inner + 2 * inner * int(config["conv_kernel"]) + 2 * inner * c
    return ffns + projections + conv


def forward_flops(config: dict, t: int) -> int:
    """FLOPs of one forward on one clip of ``t`` frames."""
    c, depth = int(config["dense_channel"]), int(config["dense_depth"])
    f = int(config["n_fft"]) // 2 + 1
    f2 = (f - 3) // 2 + 1
    encoder = 2 * 2 * c * t * f + _dense_block(c, depth, t, f) + 2 * c * c * 3 * t * f2
    token = _conformer_token(config)

    def conformer(length: int, sequences: int) -> int:
        return sequences * length * (token + 2 * 2 * length * c)

    blocks = int(config["num_tsconformers"]) * (conformer(t, f2) + conformer(f2, t))
    mask = _dense_block(c, depth, t, f2) + 2 * c * c * 3 * t * f2 + 2 * c * t * f + 2 * t * f
    phase = _dense_block(c, depth, t, f2) + 2 * c * c * 3 * t * f2 + 2 * 2 * c * t * f
    return encoder + blocks + mask + phase


def clip_flops(config: dict, samples: int) -> int:
    """FLOPs of the forward on one clip of ``samples``, zero-padded to a hop
    multiple as the runner does."""
    hop = int(config["hop_length"])
    return forward_flops(config, frames(samples + (-samples) % hop, hop))
