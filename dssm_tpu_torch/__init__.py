"""PyTorch/CUDA port of dssm_tpu for NVIDIA Hopper.

The package mirrors dssm_tpu's module names so each counterpart is easy to
find. Plain tensor code is PyTorch; every Pallas kernel on the ported path
is a hand-written CUDA kernel under ``csrc/``, built with nvcc on first use
(``kernels/_build.py``). The package imports nothing of JAX or of dssm_tpu.
"""
