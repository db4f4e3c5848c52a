"""HTTP denoise service."""

from audiodenoiser_torch.serve.server import DenoiseService, ServiceOverloaded, make_http_server

__all__ = ["DenoiseService", "ServiceOverloaded", "make_http_server"]
