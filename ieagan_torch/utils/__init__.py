"""Checkpoints (the flax msgpack reader and writer, save/load/resume), logs,
run dirs, log reading, plots and sampling."""
