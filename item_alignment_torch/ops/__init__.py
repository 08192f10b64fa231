"""Attention ops and their kernels."""
