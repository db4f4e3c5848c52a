"""The fused denoise runner and the throughput bench."""
