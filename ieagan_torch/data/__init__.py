"""Data: the event dataset over the per-sensor PNG tree, its transforms, and
the threaded loader (twin of ``ieagan_tpu/data``)."""

from ieagan_torch.data.dataset import ImageEventsDataset, event_transform, load_dataset
from ieagan_torch.data.pipeline import EventLoader, synthetic_events
from ieagan_torch.data.transforms import (BalancedSampler, CenterCropLongEdge, GaussianNoise,
                                          RandomCropLongEdge, UniformNoise)
