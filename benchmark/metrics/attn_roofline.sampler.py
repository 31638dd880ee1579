"""Attention's least time at the sites its driver declared over the device
time of the attention kernels in the traced image-sampler calls, %."""
from benchmark.harness.readings import attention_roofline


def read(run):
    return attention_roofline(run, "generate") if run.unit == "images" else None
