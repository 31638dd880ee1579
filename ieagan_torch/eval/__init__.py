"""Evaluation: clean-FID/KID with an InceptionV3 backbone, the resize that
defines the metric, and the detector-physics stats (twin of
``ieagan_tpu/eval``)."""
