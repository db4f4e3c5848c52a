"""WAV IO, chunking, the ``.npy`` pair dataset and the on-device mixer."""
