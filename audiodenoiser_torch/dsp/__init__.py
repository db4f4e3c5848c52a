"""Signal processing: windows, STFT / iSTFT, mel spectrogram, noise corruptions."""
