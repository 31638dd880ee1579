"""The port's physics stats (``ieagan_torch/eval/physics.py``) against the
JAX package's (``ieagan_tpu/eval/physics.py``): the host accumulation is the
same numpy code and must give the same numbers on the same stream; the
device reductions must give the host path's numbers on the same events
(histograms and occupancies exactly, mean charges within f32 rounding,
1e-5 relative)."""

import numpy as np
import pytest
import torch
from PIL import Image

from ieagan_tpu.eval import physics as jax_physics
from ieagan_torch.eval import physics
from ieagan_torch.models.generator import Generator
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse fixture)


def _stream(seed, n_sensors=4):
    rng = np.random.RandomState(seed)
    while True:
        adu = rng.rand(n_sensors, 32, 32) * 60.0
        adu[adu < physics.THRESHOLD] = 0.0
        adu[1, rng.rand(32, 32) < 0.5] = 0.0
        yield adu.astype(np.float32), np.arange(n_sensors)


def _assert_stats_equal(got, want, charge_rtol=0.0):
    assert got["n_events"] == want["n_events"]
    for key in ("intensity_hist", "occupancy_hist", "intensity_bins", "occupancy_bins",
                "per_sensor_occupancy"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["per_sensor_mean_charge"], want["per_sensor_mean_charge"],
                               rtol=charge_rtol, atol=0, equal_nan=True)


def test_get_stats_equals_jax():
    got = physics.get_stats(_stream(0), n_events=5)
    _assert_stats_equal(got, jax_physics.get_stats(_stream(0), n_events=5))
    assert got["intensity_hist"].sum() == 5 * 4 * 32 * 32
    assert got["per_sensor_mean_charge"].min() >= physics.THRESHOLD
    assert physics.log_transform_inv(np.array(1.0)) == pytest.approx(255.0)
    assert physics.log_transform_inv(np.array(-1.0)) == pytest.approx(0.0)


def test_zero_count_sensors_excluded_from_mean_charge():
    """Twin of ``tests/test_eval.py::test_zero_count_events_excluded_from_mean_charge``."""
    acc = physics.EventStats()
    ev_hot = np.zeros((2, 8, 8))
    ev_hot[0, 0, 0] = 50.0
    ev_hot[1] = 20.0
    ev_cold = np.zeros((2, 8, 8))
    ev_cold[1] = 10.0
    acc.update(ev_hot)
    acc.update(ev_cold)
    s = acc.summary()
    assert s["per_sensor_mean_charge"][0] == pytest.approx(50.0)
    assert s["per_sensor_mean_charge"][1] == pytest.approx(15.0)
    assert s["per_sensor_occupancy"][0] == pytest.approx(0.5 / 64)


def test_sorted_histogram_is_numpys():
    """Values on bin edges and on the last edge count as ``np.histogram``
    counts them."""
    rng = np.random.default_rng(1)
    vals = np.concatenate([rng.uniform(-2, 260, 5000), physics.INTENSITY_BINS,
                           np.zeros(100), np.full(7, 256.0)]).astype(np.float32)
    edges = torch.as_tensor(physics.INTENSITY_BINS, dtype=torch.float32)
    got = physics._sorted_histogram(torch.from_numpy(vals), edges).numpy()
    np.testing.assert_array_equal(got, np.histogram(vals, physics.INTENSITY_BINS)[0])


@pytest.fixture(scope="module")
def tiny_g():
    cfg = tiny_config(compute_dtype="float32")
    G = Generator.from_config(cfg)
    G.reset_parameters(torch.Generator().manual_seed(0))
    return G.eval(), cfg


def test_device_stats_match_host_path(tiny_g):
    """``generate_stats`` against ``get_stats(generate_event_stream)`` with the
    same seed, 6 events in blocks of 4 (the tail block trimmed)."""
    G, cfg = tiny_g
    es, h, w = cfg["n_classes"], cfg["resolution"], cfg["resolution"] * cfg["H_base"]
    stream = physics.generate_event_stream(G, cfg, seed=3, events_per_call=4)
    evs = [next(stream) for _ in range(5)]
    for adu, labels in evs:
        assert adu.shape == (es, h - 6, w)
        assert ((adu == 0) | (adu >= physics.THRESHOLD)).all()
        np.testing.assert_array_equal(labels, np.arange(es))
    assert not np.array_equal(evs[0][0], evs[1][0])
    np.testing.assert_array_equal(
        next(physics.generate_event_stream(G, cfg, seed=3, events_per_call=4))[0], evs[0][0])
    host = physics.get_stats(physics.generate_event_stream(G, cfg, seed=3, events_per_call=4),
                             n_events=6)
    dev = physics.generate_stats(G, cfg, n_events=6, seed=3, events_per_call=4)
    _assert_stats_equal(dev, host, charge_rtol=1e-5)
    assert dev["intensity_hist"].sum() == 6 * es * (h - 6) * w


def test_real_event_stream_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    for s in range(3):
        (tmp_path / f"sensor_{s}").mkdir()
        for e in range(2):
            img = np.where(rng.random((26, 32)) < 0.2, rng.integers(1, 255, (26, 32)), 0)
            Image.fromarray(img.astype(np.uint8)).save(tmp_path / f"sensor_{s}" / f"ev{e}.png")
    got = list(physics.real_event_stream(str(tmp_path), seed=1))
    want = list(jax_physics.real_event_stream(str(tmp_path), seed=1))
    assert len(got) == len(want) == 2
    for (a, la), (b, lb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    stats = physics.compare_models({}, {}, n_events=2, real_dataroot=str(tmp_path), seed=1)
    _assert_stats_equal(stats["real"], jax_physics.get_stats(iter(want), n_events=2))
