"""WAV IO, chunking, the ``.npy`` pair dataset and the on-device mixer."""

from audiodenoiser_torch.data.chunking import frame_audio, match_audio_length, pad_or_truncate
from audiodenoiser_torch.data.dataset import SpectrogramPairs, batches, split_train_val
from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
from audiodenoiser_torch.data.wav_io import load_wav_list, read_wav, write_wav

__all__ = ["read_wav", "write_wav", "load_wav_list", "frame_audio", "match_audio_length",
           "pad_or_truncate", "SpectrogramPairs", "split_train_val", "batches",
           "OnDeviceMixer", "NoiseBank"]
