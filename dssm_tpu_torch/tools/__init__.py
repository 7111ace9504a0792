"""Measurement scripts for the port's kernels, run on a machine with an
NVIDIA GPU (`python -m dssm_tpu_torch.tools.<name>`)."""
