"""Data- and tensor-parallel training over ``torch.distributed``: process
bootstrap, collectives with autograd, the split layers of the model axis,
and the sharded train step (twins of ``ieagan_tpu/parallel/``)."""
