"""Training: the optimizer and the pretrain / eval steps."""
