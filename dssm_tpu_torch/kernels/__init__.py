"""Kernels of the port: each CUDA kernel's wrapper beside its plain version.

Importing this package builds nothing; kernels/_build.py compiles csrc/ on
the first launch.
"""
