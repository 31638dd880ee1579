"""Training: the fused D+G step, its optimizers and orthogonal regularization."""
