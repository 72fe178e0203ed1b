"""gloria_tpu_torch: the PyTorch + CUDA port of gloria_tpu for NVIDIA Hopper.

It mirrors ``gloria_tpu``'s layout and keeps its public layouts (images
``[B, H, W, 3]``, region embeddings ``[B, R, D]``, word embeddings
``[T, W, D]``).  It imports ``torch`` and never JAX, flax or ``gloria_tpu``.
This slice serves zero-shot classification: ``api.load_gloria``,
``api.GloriaModel``, ``serving.InferenceEngine`` and
``python -m gloria_tpu_torch.serving --ckpt <file.ckpt>``.  The local
similarity runs as the hand-written CUDA kernel ``csrc/local_sim_fwd.cu``.
"""
