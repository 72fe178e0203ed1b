"""The weights bridge from JAX variables and the CUDA build helper."""
