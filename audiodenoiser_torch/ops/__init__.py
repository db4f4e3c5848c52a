"""Kernels of the port: ``ops.cuda`` holds the CUDA C++ ones."""
