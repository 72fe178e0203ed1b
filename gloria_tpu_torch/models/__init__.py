"""PyTorch modules named by the reference's torch keys."""
