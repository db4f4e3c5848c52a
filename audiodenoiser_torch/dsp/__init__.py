"""Signal processing: windows, STFT / iSTFT, Griffin-Lim, mel spectrogram,
noise corruptions."""

from audiodenoiser_torch.dsp import griffin_lim as griffin_lim_mod
from audiodenoiser_torch.dsp import mel as mel_mod
from audiodenoiser_torch.dsp import noise
from audiodenoiser_torch.dsp import stft as stft_mod
from audiodenoiser_torch.dsp.griffin_lim import griffin_lim
from audiodenoiser_torch.dsp.mel import mel_filterbank, mel_spectrogram
from audiodenoiser_torch.dsp.stft import (
    frame_signal,
    istft,
    magnitude,
    magphase,
    num_frames,
    overlap_add,
)
from audiodenoiser_torch.dsp.window import hann_window

# the STFT itself is ``stft_mod.stft``: exported here it would shadow the
# ``stft`` submodule's name
compute_stft = stft_mod.stft

__all__ = ["compute_stft", "frame_signal", "griffin_lim", "hann_window", "istft", "magnitude",
           "magphase", "mel_filterbank", "mel_spectrogram", "noise", "num_frames",
           "overlap_add", "stft_mod", "griffin_lim_mod", "mel_mod"]
