"""The port's event producer (``ieagan_torch/deploy/producer.py``) against the
JAX package's (``ieagan_tpu/deploy/producer.py``) and ``tests/test_deploy.py``'s
contracts: the C++ sparse-digit library built by the port equals its numpy
version and the JAX package's extraction exactly; the producer's digits are
those of the same generated blocks; shards hold what the JAX package's
writer writes; the basf2 module appends the queued digits (basf2 faked as
in ``tests/test_deploy.py``)."""

import numpy as np
import pytest
import torch

from ieagan_tpu.deploy import producer as jax_prod
from ieagan_torch.deploy import Model, generate_block
from ieagan_torch.deploy import producer as prod
from tests.test_deploy import _install_fake_basf2
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse fixture)

CFG = dict(resolution=32, n_classes=4, H_base=1, G_ch=4, G_depth=1, G_attn="0",
           use_pallas_attention=False)


def _cases():
    rng = np.random.RandomState(0)
    imgs = rng.rand(3, 25, 77).astype(np.float32) * 80.0
    imgs[imgs < 40] = 0.0
    yield imgs, 0.0
    yield np.array([[[0.0, 7.5, 300.0, 254.6]]], np.float32), 7.0
    yield np.array([[[-3.0, 0.5, 1e9, 255.9]]], np.float32), 0.0
    yield np.zeros((2, 4, 4), np.float32), 0.0


@pytest.mark.parametrize("case", range(4))
def test_native_digits_equal_numpy_and_jax(case):
    imgs, threshold = list(_cases())[case]
    coords, charges = prod.extract_sparse_digits(imgs, threshold)
    assert coords.dtype == np.int32 and charges.dtype == np.uint8 and coords.shape[1:] == (3,)
    for want_coords, want_charges in (prod.extract_sparse_digits_plain(imgs, threshold),
                                      jax_prod.extract_sparse_digits(imgs, threshold)):
        np.testing.assert_array_equal(coords, want_coords)
        np.testing.assert_array_equal(charges, want_charges)


def test_library_is_built_from_the_ports_source():
    path = prod.native_library_path()
    assert path.parent == prod.kernel_build.BUILD_DIR and path.name.startswith("sparse_digits-")
    assert prod.build_native()["path"] == path and path.exists()
    assert "-march=native" not in prod.CXX_FLAGS


def test_build_failure_raises(tmp_path, monkeypatch):
    """No silent fallback: a compiler that fails, or is missing, raises."""
    monkeypatch.setattr(prod.kernel_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(prod, "_NATIVE", None)
    for cxx in ("false", str(tmp_path / "no-such-compiler")):
        monkeypatch.setenv("CXX", cxx)
        with pytest.raises(RuntimeError, match="sparse-digit library"):
            prod.extract_sparse_digits(np.ones((1, 2, 2), np.float32))
    assert not list(tmp_path.glob("*.so"))


def test_producer_round_trip():
    """Three events from blocks of 2 chunks of 1 event: each event's digits
    are those of the same event in ``generate_block`` from the same seed."""
    m = Model(config=CFG, device="cpu")
    events = list(prod.EventProducer(m, num_events=3, events_per_call=1, chunks=2,
                                     seed=0).start())
    gen = torch.Generator().manual_seed(0)
    blocks = np.concatenate([generate_block(m, 1, 2, gen).numpy() for _ in range(2)])
    assert len(events) == 3
    for e, (coords, charges) in enumerate(events):
        want = prod.extract_sparse_digits_plain(blocks[e * 4:(e + 1) * 4])
        np.testing.assert_array_equal(coords, want[0])
        np.testing.assert_array_equal(charges, want[1])
        assert len(coords) == int((blocks[e * 4:(e + 1) * 4] > 0).sum())
        if len(coords):
            assert coords[:, 0].max() < 4 and coords[:, 1].max() < 26


def test_producer_error_reaches_the_consumer():
    m = Model(config=CFG, device="cpu")
    p = prod.EventProducer(m, num_events=2, events_per_call=1, chunks=1)
    p._generate = lambda generator: (_ for _ in ()).throw(ValueError("boom"))
    with pytest.raises(RuntimeError, match="producer failed"):
        list(p.start())
    p.join(timeout=10)
    assert not p._thread.is_alive()


def test_npz_shards_equal_jax(tmp_path):
    digits = [(np.arange(15, dtype=np.int32).reshape(5, 3) * i, np.full(5, i, np.uint8))
              for i in range(3)]
    for name, writer in (("port", prod.NpzWriter), ("jax", jax_prod.NpzWriter)):
        w = writer(str(tmp_path / name), events_per_shard=2)
        for d in digits:
            w.write(d)
        w.flush()
    for shard in ("events_00000.npz", "events_00001.npz"):
        got, want = np.load(tmp_path / "port" / shard), np.load(tmp_path / "jax" / shard)
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].dtype == want[key].dtype
    assert not (tmp_path / "port" / "events_00002.npz").exists()


def test_digit_creator_appends_queue_digits(monkeypatch, tmp_path):
    """``produce_events`` drives the faked basf2 loop; every appended digit is
    the producer's for the same model and seed; the VxdID table covers the
    40 PXD sensors (layer 1: 8 ladders x 2, layer 2: 12 ladders x 2)."""
    store_cls = _install_fake_basf2(monkeypatch)
    store_cls.instances.clear()
    m = Model(config=CFG, device="cpu")
    expected = list(prod.EventProducer(m, num_events=2, events_per_call=1, seed=5).start())
    assert prod.produce_events(m, 2, out_dir=None, events_per_call=1, seed=5) == 2
    (store,) = store_cls.instances
    assert store.name == "PXDDigits" and store.registered
    want = [(int(r), int(c), int(ch)) for coords, charges in expected
            for (_, r, c), ch in zip(coords, charges)]
    got = [(s.digit.row, s.digit.col, s.digit.charge) for s in store.slots]
    assert got == want

    producer = prod.EventProducer(m, num_events=1, events_per_call=1).start()
    creator = prod.make_digit_creator(producer)
    creator.initialize()
    ids = [v.id for v in creator.vxd_ids]
    assert len(ids) == 40 and len(set(ids)) == 40
    assert sum(1 for layer, *_ in ids if layer == 1) == 16
    producer.stop()


def test_without_basf2_events_go_to_npz_shards(tmp_path, monkeypatch):
    monkeypatch.setattr(prod, "make_digit_creator", lambda producer: None)
    m = Model(config=CFG, device="cpu")
    assert prod.produce_events(m, 3, out_dir=str(tmp_path), events_per_call=1, seed=1) == 3
    (shard,) = tmp_path.glob("events_*.npz")
    assert int(np.load(shard)["n_events"]) == 3
