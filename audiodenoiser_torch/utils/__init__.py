"""Instrumentation helpers and numerical guards."""

from audiodenoiser_torch.utils.debug import assert_tree_finite
from audiodenoiser_torch.utils.profiling import maybe_trace, timed

__all__ = ["maybe_trace", "timed", "assert_tree_finite"]
