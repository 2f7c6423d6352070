"""Wavelet transforms and the hand-written CUDA kernels (K1, K2, K3)."""
