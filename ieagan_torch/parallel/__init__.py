"""Data-parallel training over ``torch.distributed``: process bootstrap,
collectives with autograd, and the sharded train step (twins of
``ieagan_tpu/parallel/``)."""
