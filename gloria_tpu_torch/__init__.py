"""gloria_tpu_torch: the PyTorch + CUDA port of gloria_tpu for NVIDIA Hopper.

It mirrors ``gloria_tpu``'s layout and keeps its public layouts (images
``[B, H, W, 3]``, region embeddings ``[B, R, D]``, word embeddings
``[T, W, D]``).  It imports ``torch`` and never JAX, flax or ``gloria_tpu``.
It serves zero-shot classification (``api.load_gloria``,
``api.GloriaModel``, ``serving.InferenceEngine``,
``python -m gloria_tpu_torch.serving --ckpt <file.ckpt>``) and takes GLoRIA
pretrain steps (``training.optim.make_optimizer``,
``training.train.make_pretrain_steps``) and trains from a config file
(``python -m gloria_tpu_torch.run -c <cfg> --train``: ``builder``,
``training.trainer``, ``training.checkpoints``).  The local similarity runs as the
hand-written CUDA kernels ``csrc/local_sim_fwd.cu`` (forward) and
``csrc/local_sim_bwd.cu`` (backward).  ``experiments.fused_bn`` keeps the
archived fused bottleneck tail, which no model path calls, with its CUDA
kernels ``csrc/fused_bn_fwd.cu`` and ``csrc/fused_bn_bwd.cu``.
"""
