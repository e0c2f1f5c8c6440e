"""Quantization numerics of the port: affine grids, fake-quant, calibration
analyzers and blockwise / LPBQ encodings."""
