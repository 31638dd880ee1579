"""Checkpoints: the port's and the JAX package's files, each read by the other.

Leaf-equal means equal bit for bit: every leaf the one side wrote is the
value the other side restores (weights, u/sv, batch stats, the standing
counter, Adam's mu/nu and both counts, and the state_dict's itr), with no
tolerance. The repo's optimizer files of ``copy16000`` pass through the port's
optimizer and back unchanged, and a pre-schedule ("legacy") optimizer file
is grafted as the JAX package grafts it.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from ieagan_tpu.models import Discriminator as JaxD
from ieagan_tpu.models import Generator as JaxG
from ieagan_tpu.train import init_train_state as jax_init
from ieagan_tpu.utils import load_checkpoint as jax_load
from ieagan_tpu.utils import save_checkpoint as jax_save
from ieagan_torch.core.config import DEFAULT_CONFIG
from ieagan_torch.models.convert import (discriminator_state_to_flax, generator_state_to_flax,
                                         optimizer_state_from_flax, optimizer_state_to_flax)
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.train.optim import make_optimizer
from ieagan_torch.train.step import init_train_state
from ieagan_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ieagan_torch.utils.flax_msgpack import msgpack_serialize, read_checkpoint
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)

CONFIG = tiny_config(compute_dtype="float32")
CHECKPOINT = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / "flagship_r4b"


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _port_state(seed=0):
    G, D = Generator.from_config(CONFIG), Discriminator.from_config(CONFIG)
    return init_train_state(G, D, CONFIG, torch.Generator().manual_seed(seed))


def _randomize(state, seed):
    """Random moments, stats and counts, so no leaf is at its init value."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in (state.G, state.D, state.G_ema):
            for t in list(module.parameters()) + list(module.buffers()):
                t.add_(torch.rand(t.shape, generator=gen))
        for k, opt in enumerate((state.opt_G, state.opt_D)):
            for p in opt.params:
                for m in opt.moment_names:
                    opt.state[p][m].copy_(torch.rand(p.shape, generator=gen))
            opt.count, opt.sched_count = 17 + k, 19 + k
    state.itr = 23
    return state


def _port_trees(state):
    return {"G": generator_state_to_flax(state.G), "D": discriminator_state_to_flax(state.D),
            "G_ema": generator_state_to_flax(state.G_ema),
            "G_optim": optimizer_state_to_flax(state.opt_G, state.G),
            "D_optim": optimizer_state_to_flax(state.opt_D, state.D)}


def _jax_trees(state):
    sd = serialization.to_state_dict
    return {"G": {"params": state.params_G, "state": state.state_G},
            "D": {"params": state.params_D, "state": state.state_D},
            "G_ema": {"params": state.params_G_ema, "state": state.state_G_ema},
            "G_optim": sd(state.opt_G), "D_optim": sd(state.opt_D)}


@pytest.fixture(scope="module")
def jax_template():
    return jax_init(JaxG.from_config(CONFIG), JaxD.from_config(CONFIG), CONFIG,
                    jax.random.PRNGKey(0))


def test_port_round_trip(tmp_path):
    state = _randomize(_port_state(), 1)
    save_checkpoint(tmp_path, state, {"itr": 0, "epoch": 2, "best_FID": 7.5}, "copy23")
    assert latest_checkpoint(tmp_path) == "copy23"
    fresh = _port_state(seed=5)
    fresh, sd = load_checkpoint(tmp_path, fresh, "copy23")
    assert sd == {"itr": 23, "epoch": 2, "best_FID": 7.5} and fresh.itr == 23
    _assert_trees_equal(_port_trees(fresh), _port_trees(state))
    assert not list(tmp_path.glob("*.tmp"))


def test_port_writes_jax_restores(tmp_path, jax_template):
    state = _randomize(_port_state(), 2)
    save_checkpoint(tmp_path, state, {"itr": 0, "epoch": 1}, "copy23")
    restored, sd = jax_load(tmp_path, jax_template, "copy23")
    assert int(restored.itr) == 23 and sd["epoch"] == 1
    _assert_trees_equal(_jax_trees(restored), _port_trees(state))


def test_jax_writes_port_restores(tmp_path, jax_template):
    """A JAX TrainState with every leaf randomized (moments, counts, stats)."""
    rng = np.random.default_rng(3)

    def rand(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return jnp.asarray(rng.integers(1, 1000, x.shape).astype(x.dtype))
        return jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype))

    state = jax.tree_util.tree_map(rand, jax_template)
    state = state.replace(itr=jnp.asarray(31, jnp.int32))
    jax_save(tmp_path, state, {"itr": 0, "epoch": 3}, "copy31")
    port, sd = load_checkpoint(tmp_path, _port_state(), "copy31")
    assert port.itr == 31 and sd["epoch"] == 3
    _assert_trees_equal(_port_trees(port), _jax_trees(state))


def test_legacy_optimizer_file_is_grafted(tmp_path, jax_template, capsys):
    """An optimizer file from before the JAX package's schedule wrapper (an
    empty state where the schedule's count is): the moments and the Adam
    count are taken from it, the schedule's count is seeded with the
    resumed itr (``ieagan_tpu/utils/checkpoint.py:279-308``)."""
    rng = np.random.default_rng(4)
    state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32))
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, jax_template)
    state = state.replace(itr=jnp.asarray(12, jnp.int32))
    jax_save(tmp_path, state, {"itr": 0}, "copy12")
    legacy_tx = optax.adam(1e-4, b1=0.0, b2=0.999, eps=1e-6)
    for base, params in (("G_optim", state.params_G), ("D_optim", state.params_D)):
        legacy = legacy_tx.init(params)
        legacy = (legacy[0]._replace(
            count=jnp.asarray(9, jnp.int32),
            mu=jax.tree_util.tree_map(lambda p: p * 2.0, params),
            nu=jax.tree_util.tree_map(lambda p: p * p, params)), legacy[1])
        assert isinstance(legacy[-1], optax.EmptyState)
        (tmp_path / f"{base}_copy12.msgpack").write_bytes(serialization.to_bytes(legacy))
    port, _ = load_checkpoint(tmp_path, _port_state(), "copy12")
    assert "legacy optimizer structure" in capsys.readouterr().out
    jax_restored, _ = jax_load(tmp_path, jax_template, "copy12")
    for net, opt, module in (("G", port.opt_G, port.G), ("D", port.opt_D, port.D)):
        assert (opt.count, opt.sched_count) == (9, 12)
        _assert_trees_equal(optimizer_state_to_flax(opt, module),
                            serialization.to_state_dict(getattr(jax_restored, f"opt_{net}")))


@pytest.mark.parametrize("net", ["G", "D"])
def test_copy16000_optimizer_file_round_trips(net, tmp_path):
    """The flagship run's optimizer file (16000 steps of Adam moments) read
    into the port's optimizer over the flagship modules, written again and
    read back: every leaf equal, and the bytes equal the original file's."""
    path = f"{CHECKPOINT}/{net}_optim_copy16000.msgpack"
    tree = read_checkpoint(path)
    module = (Generator if net == "G" else Discriminator).from_config(DEFAULT_CONFIG)
    opt = make_optimizer(module.parameters(), DEFAULT_CONFIG[f"{net}_B1"],
                         DEFAULT_CONFIG[f"{net}_B2"], DEFAULT_CONFIG["adam_eps"])
    optimizer_state_from_flax(opt, module, tree)
    assert opt.count == opt.sched_count == 16000
    out = tmp_path / "optim.msgpack"
    out.write_bytes(msgpack_serialize(optimizer_state_to_flax(opt, module)))
    _assert_trees_equal(read_checkpoint(out), tree)
    with open(path, "rb") as fp:
        assert out.read_bytes() == fp.read()
    with open(f"{CHECKPOINT}/state_dict_copy16000.json") as fp:
        assert json.load(fp)["itr"] == 16000


def test_writer_matches_msgpack_on_every_format():
    """The port's encoder against msgpack's (as flax calls it) on each format
    and its size boundaries: ints, floats, strings, bytes, arrays, maps (keys
    given in sorted order: the writer sorts them, as flax's tree map does)."""
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    objs = ints + [None, True, False, 1.5, -0.0, "", "a" * 31, "a" * 32, "é" * 200,
                   "b" * 70000, b"", b"x" * 255, b"x" * 256, b"x" * 70000,
                   list(range(15)), list(range(16)), list(range(70000)),
                   {f"{i:05d}": i for i in range(15)}, {f"{i:05d}": i for i in range(16)},
                   {f"{i:05d}": [i] for i in range(70000)}]
    for obj in objs:
        want = msgpack.packb(obj, use_bin_type=True)
        got = msgpack_serialize(obj)
        assert got == want, repr(obj)[:60]
    arrays = {"a": np.arange(3, dtype=np.int32), "b": np.float32(2.5), "c": np.zeros((0, 4)),
              "d": np.ones((2, 3), np.float64), "e": np.array(7, np.int64)}
    assert msgpack_serialize(arrays) == serialization.msgpack_serialize(arrays)
