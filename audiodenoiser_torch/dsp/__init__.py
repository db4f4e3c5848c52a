"""Signal processing: windows, STFT / iSTFT."""
