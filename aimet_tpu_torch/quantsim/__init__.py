"""Quantization simulation and its lowering to integer kernels."""
