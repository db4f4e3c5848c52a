"""Training: optimizer, train/eval steps, the fit loop, exports and logs."""
