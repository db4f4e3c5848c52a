"""WAV IO and resampling on the host."""
