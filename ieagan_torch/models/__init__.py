"""The port's models and the carry-over of JAX-package checkpoints."""
