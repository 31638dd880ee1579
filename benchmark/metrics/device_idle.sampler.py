"""Share of the traced window of image-sampler calls in which no kernel,
copy or memset ran, %."""
from benchmark.harness.readings import device_idle


def read(run):
    return device_idle(run, "generate") if run.unit == "images" else None
