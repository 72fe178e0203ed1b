"""Similarity math, resize and word aggregation; the CUDA kernel wrappers."""
