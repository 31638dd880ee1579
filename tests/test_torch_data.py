"""The port's data path against the JAX package's, on the event tree that
``scripts/make_synthetic_dataset.py`` writes (the repo has no PXD data).

Dataset items and loader batches are numpy on both sides, drawn from the
same ``np.random.Generator`` streams: equal bit for bit. The port's loader,
given a device, yields the same values as tensors. The device transform
(``ops/image_norm.py``) against the host chain with the noise off: within
2e-6, the bound ``tests/test_data.py`` holds the JAX twin to (float32 log in
two libraries).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ieagan_tpu.data import EventLoader as JaxLoader
from ieagan_tpu.data import ImageEventsDataset as JaxDataset
from ieagan_tpu.data.dataset import event_transform as jax_event_transform
from ieagan_tpu.data.dataset import event_transform_stack as jax_transform_stack
from ieagan_torch.data import EventLoader, ImageEventsDataset, load_dataset, synthetic_events
from ieagan_torch.data.dataset import event_transform, event_transform_stack
from ieagan_torch.ops.image_norm import device_event_transform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("syn") / "pxd"
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synthetic_dataset.py"),
                    str(out), "--events", "7", "--sensors", "4", "--height", "26",
                    "--width", "32", "--seed", "0"], check=True, capture_output=True)
    return str(out)


@pytest.mark.parametrize("raw_uint8", [False, True])
def test_items_equal_jax(tree, raw_uint8):
    ours = ImageEventsDataset(tree, seed=11, raw_uint8=raw_uint8)
    theirs = JaxDataset(tree, seed=11, raw_uint8=raw_uint8)
    assert (len(ours), ours.n_sensors, ours.subdirs) == (len(theirs), theirs.n_sensors,
                                                         theirs.subdirs)
    for i in range(len(ours)):
        (a, la), (b, lb) = ours[i], theirs[i]
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    assert ours[0][0].shape == ((4, 26, 32) if raw_uint8 else (4, 32, 32, 1))


def test_transforms_equal_jax():
    rng = np.random.RandomState(0)
    img = (rng.rand(20, 24) * 255).astype(np.uint8)
    stack = (rng.rand(3, 20, 24) * 255).astype(np.uint8)
    for seed in (None, 5):
        mk = lambda: None if seed is None else np.random.default_rng(seed)
        np.testing.assert_array_equal(event_transform(img, mk()), jax_event_transform(img, mk()))
        np.testing.assert_array_equal(event_transform(img.astype(np.float32), mk()),
                                      jax_event_transform(img.astype(np.float32), mk()))
        np.testing.assert_array_equal(event_transform_stack(stack, mk()),
                                      jax_transform_stack(stack, mk()))


def test_epoch_order_and_set_epoch_equal_jax(tree):
    """Three epochs of the shuffled loader, then a loader resumed at epoch 2
    with ``set_epoch``: the batches of each, in order, equal the JAX loader's."""
    def batches(loader, epochs):
        return [[(np.asarray(x), np.asarray(y)) for x, y in loader] for _ in range(epochs)]

    kw = dict(num_workers=2, shuffle=True, seed=3, events_per_batch=2)
    ours = batches(EventLoader(ImageEventsDataset(tree, seed=3), **kw), 3)
    theirs = batches(JaxLoader(JaxDataset(tree, seed=3), process_index=0, process_count=1,
                               **kw), 3)
    assert len(ours[0]) == 3  # 7 events, 2 per batch, the last dropped
    for e_ours, e_theirs in zip(ours, theirs):
        for (a, la), (b, lb) in zip(e_ours, e_theirs, strict=True):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)
    assert not all(np.array_equal(a[0], b[0]) for a, b in zip(ours[0], ours[1]))
    resumed = EventLoader(ImageEventsDataset(tree, seed=3), **kw)
    resumed.set_epoch(2)
    for (a, la), (b, lb) in zip(batches(resumed, 1)[0], ours[2], strict=True):
        np.testing.assert_array_equal(a, b)


def test_loader_on_a_device_yields_tensors(tree):
    loader = load_dataset(tree, num_workers=2, shuffle=True, seed=3, events_per_batch=2)
    want = [(x, y) for x, y in loader]
    loader.device = "cpu"
    loader.set_epoch(0)
    got = list(loader)
    assert len(got) == len(want) == len(loader)
    for (x, y), (a, b) in zip(got, want):
        assert isinstance(x, torch.Tensor) and y.dtype == torch.int64
        np.testing.assert_array_equal(x.numpy(), a)
        np.testing.assert_array_equal(y.numpy(), b)


def test_device_transform_matches_host_chain():
    raw = (np.random.RandomState(0).rand(5, 58, 64) * 255).astype(np.uint8)
    host = jax_transform_stack(raw, None, 0.0)
    dev = device_event_transform(torch.from_numpy(raw), None, 0.0).numpy()
    assert dev.shape == host.shape == (5, 64, 64, 1)
    np.testing.assert_allclose(dev, host, atol=2e-6)
    noisy = device_event_transform(torch.from_numpy(raw), torch.Generator().manual_seed(0))
    diff = noisy.numpy() - dev
    assert 0.0 <= diff.min() and diff.max() < 2 * 4e-3 and diff.std() > 1e-3


def test_synthetic_events_equal_jax():
    from ieagan_tpu.data import synthetic_events as jax_synthetic
    cfg = dict(n_classes=4, events_per_batch=2, resolution=16, H_base=2)
    for (a, la), (b, lb) in zip(synthetic_events(cfg, 3, seed=1), jax_synthetic(cfg, 3, seed=1),
                                strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_loader_raises_what_its_producer_raised(tree):
    """A batch that fails to load ends the epoch with the error, not quietly
    (the JAX loader's producer thread drops it and ends the epoch early)."""
    class Broken(ImageEventsDataset):
        def __getitem__(self, i):
            if i == 3:
                raise OSError("unreadable event")
            return super().__getitem__(i)

    loader = EventLoader(Broken(tree), num_workers=2, shuffle=False, events_per_batch=2)
    with pytest.raises(OSError, match="unreadable event"):
        list(loader)
