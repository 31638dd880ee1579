"""The port's flax-msgpack reader and carry-over of checkpoints.

The reader must give exactly what ``flax.serialization`` gives (same keys,
bitwise-equal arrays) without flax, jax or msgpack; the carry-over must use
every key of the checkpoint and raise on a missing or unknown one.
"""

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from ieagan_torch.models.convert import generator_state_from_flax
from ieagan_torch.models.generator import Generator
from ieagan_torch.deploy import FROZEN_CONFIG
from ieagan_torch.utils import flax_msgpack
from ieagan_torch.utils.flax_msgpack import (
    latest_checkpoint, msgpack_restore, read_checkpoint, resolve_generator_checkpoint)

CHECKPOINT = "artifacts/flagship_r4b"
BEST0 = f"{CHECKPOINT}/G_ema_best0.msgpack"


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_same_tree(got, want):
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for key, w in want_leaves.items():
        g = got_leaves[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), key
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert g.tobytes() == w.tobytes(), key
        else:
            assert type(g) is type(w) and g == w, key


@pytest.fixture(scope="module")
def best0():
    with open(BEST0, "rb") as fp:
        data = fp.read()
    return data, read_checkpoint(BEST0)


def test_reader_is_bitwise_flax_on_best0(best0):
    data, tree = best0
    assert set(tree) == {"params", "state"}
    _assert_same_tree(tree, serialization.msgpack_restore(data))


def test_reader_matches_flax_on_dtypes_scalars_and_chunks(monkeypatch):
    """Leaf kinds beyond the float32 arrays of best0: other dtypes, 0-d
    arrays, numpy scalars (ext type 3), complex numbers (ext type 2), Python
    scalars, and arrays that flax splits into chunks (forced here by a small
    chunk size)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal(7).astype(np.float16),
        "i32": rng.integers(-9, 9, (2, 2, 2)).astype(np.int32),
        "u8": rng.integers(0, 255, 300).astype(np.uint8),
        "b": rng.random(4) > 0.5,
        "zero_d": np.asarray(2.5, np.float32),
        "np_scalar": np.float32(1.25),
        "cplx": 1.5 - 2j,
        "py": {"int": 7, "neg": -3, "big": 2 ** 40, "float": 0.1, "str": "x" * 40,
               "none": None, "flag": True},
        "big": rng.standard_normal(100).astype(np.float64),
    }
    data = serialization.msgpack_serialize(tree)
    _assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


def test_unpackb_matches_msgpack_on_every_format():
    obj = {
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 + 5,
                 -1, -32, -33, -128, -129, -32768, -32769, -(2 ** 31) - 1, -(2 ** 62)],
        "floats": [0.5, -1e300, float("inf")],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "ü"],
        "bins": [b"", b"\x00" * 300, b"\x01" * 70000],
        "arr16": list(range(20)), "arr32": list(range(70000)),
        "map16": {str(i): i for i in range(20)},
        "exts": [msgpack.ExtType(5, b"x" * n) for n in (1, 2, 4, 8, 16, 3, 300, 70000)],
        "misc": [None, True, False],
    }
    data = msgpack.packb(obj, use_bin_type=True)
    got = flax_msgpack.unpackb(data)
    want = msgpack.unpackb(data, raw=False, strict_map_key=False)
    got["exts"] = [msgpack.ExtType(c, d) for c, d in got["exts"]]
    assert got == want
    assert flax_msgpack.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5


def test_reader_rejects_damaged_data(best0):
    data, _ = best0
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[: len(data) // 2])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="not a flax record"):
        msgpack_restore(msgpack.packb({"a": msgpack.ExtType(9, b"")}))


def test_carry_over_uses_every_key_of_best0(best0):
    _, tree = best0
    template = Generator.from_config(FROZEN_CONFIG).state_dict()
    state = generator_state_from_flax(tree, template)
    assert len(state) == len(template) == len(list(_leaves(tree)))
    assert state["blocks_0_0.conv2.weight"].shape == (128, 128, 3, 3)
    np.testing.assert_array_equal(
        state["blocks_0_0.conv2.weight"],
        tree["params"]["blocks_0_0"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["linear_f.weight"],
                                  tree["params"]["linear_f"]["kernel"].T)
    np.testing.assert_array_equal(state["RR_G.norm.weight"],
                                  tree["params"]["RR_G"]["norm"]["scale"])
    np.testing.assert_array_equal(state["blocks_5_1.bn4.gain.u"],
                                  tree["state"]["spectral"]["blocks_5_1"]["bn4"]["gain"]["u"])
    assert state["output_bn.accumulation_counter"].shape == ()


def test_carry_over_raises_on_missing_unused_unknown_and_misshapen_keys(best0):
    _, tree = best0
    template = Generator.from_config(FROZEN_CONFIG).state_dict()

    def edited(edit):
        t = {"params": dict(tree["params"]),
             "state": {k: dict(v) for k, v in tree["state"].items()}}
        edit(t)
        return t

    with pytest.raises(KeyError, match="missing"):
        generator_state_from_flax(edited(lambda t: t["params"].pop("linear_f")), template)
    with pytest.raises(KeyError, match="unused"):
        generator_state_from_flax(edited(lambda t: t["params"].__setitem__(
            "extra", {"bias": np.zeros(3, np.float32)})), template)
    with pytest.raises(KeyError, match="no counterpart"):
        generator_state_from_flax(edited(lambda t: t["params"].__setitem__(
            "odd", {"weird": np.zeros(3, np.float32)})), template)
    with pytest.raises(KeyError, match="no counterpart"):
        generator_state_from_flax(edited(lambda t: t["state"].__setitem__(
            "cache", {"x": np.zeros(1, np.float32)})), template)
    with pytest.raises(ValueError, match="shape"):
        generator_state_from_flax(edited(lambda t: t["params"].__setitem__(
            "shared", {"embedding": np.zeros((40, 64), np.float32)})), template)


def test_checkpoint_resolution(tmp_path):
    assert latest_checkpoint(CHECKPOINT) == "copy16000"
    assert resolve_generator_checkpoint(CHECKPOINT, tag="best0").endswith("G_ema_best0.msgpack")
    assert resolve_generator_checkpoint(CHECKPOINT).endswith("G_ema_copy16000.msgpack")
    assert resolve_generator_checkpoint(CHECKPOINT, use_ema=False).endswith("G_copy16000.msgpack")
    assert resolve_generator_checkpoint(BEST0) == BEST0
    assert latest_checkpoint(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        resolve_generator_checkpoint(str(tmp_path), tag="best0")


def test_restored_best0_holds_the_checkpoint_values(best0):
    _, tree = best0
    from ieagan_torch.deploy import Model
    model = Model.restore(CHECKPOINT, tag="best0", device="cpu")
    assert not model.G.training
    torch.testing.assert_close(
        model.G.linear.u, torch.tensor(tree["state"]["spectral"]["linear"]["u"]),
        rtol=0, atol=0)
    torch.testing.assert_close(
        model.G.output_bn.var,
        torch.tensor(tree["state"]["batch_stats"]["output_bn"]["var"]), rtol=0, atol=0)
