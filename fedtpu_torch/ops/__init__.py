"""Losses, the CUDA kernels and the update codecs."""
