"""The port's InceptionV3 (``ieagan_torch/eval/inception.py``) against the
JAX package's (``ieagan_tpu/eval/inception.py``), and the golden file
``ieagan_torch/eval/golden_inception.json`` that ``chip_smoke.py`` holds the
card to.

Both sides take the same numpy state dict (torch layout; the JAX side through
``convert_torch_state_dict``) and the same numpy inputs, the JAX side NHWC.
Bounds: blocks within 1e-4 absolute on O(1) activations; whole-network
features within 1e-5 of the largest feature (the port reads 1.5e-6 with the
fallback weights and 3.2e-7 with the PXD backbone: f32 sums over 94
convolutions in another order).

Write the golden file anew with ``PYTHONPATH=. python tests/test_torch_inception.py --write``.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieagan_tpu.eval import fid as jax_fid
from ieagan_tpu.eval import inception as jax_inc
from ieagan_torch.eval import golden
from ieagan_torch.eval import inception as inc
from ieagan_torch.eval.fid import FeatureExtractor
from ieagan_torch.utils.flax_msgpack import read_checkpoint
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse fixture)

PXD = "stats/inception_pxd.msgpack"
FEATURE_RTOL = 1e-5


def random_state(module: torch.nn.Module, seed: int) -> dict:
    """He-normal conv weights and non-trivial batch-norm fields for every
    ``BasicConv2d`` of ``module``, numpy-seeded, torch layout."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, value in module.state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("conv.weight"):
            out[key] = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif key.endswith("running_var") or key.endswith("bn.weight"):
            out[key] = rng.uniform(0.5, 1.5, shape)
        else:
            out[key] = rng.standard_normal(shape) * 0.1
    return {k: v.astype(np.float32) for k, v in out.items()}


def port_apply(module, state, x_nhwc):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    with torch.no_grad():
        out = module.eval()(torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy()))
    return out.numpy().transpose(0, 2, 3, 1) if out.ndim == 4 else out.numpy()


def jax_apply(module, state, x_nhwc, prefix=None):
    params = jax_inc.convert_torch_state_dict(state)
    return np.asarray(module.apply({"params": params[prefix] if prefix else params},
                                   jnp.asarray(x_nhwc)))


@pytest.mark.parametrize("k,s,p", [((3, 3), (2, 2), (0, 0)), ((1, 7), (1, 1), (0, 3)),
                                   ((5, 5), (1, 1), (2, 2))])
def test_basic_conv2d_matches_jax(k, s, p):
    block = torch.nn.Module()
    block.blk = inc.BasicConv2d(5, 8, k, stride=s, padding=p)
    state = random_state(block, 0)
    x = np.random.default_rng(1).random((2, 21, 23, 5), dtype=np.float32)
    got = port_apply(block.blk, {k2[4:]: v for k2, v in state.items()}, x)
    want = jax_apply(jax_inc.BasicConv2d(8, k, strides=s, padding=p), state, x, "blk")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_pools_match_jax():
    x = np.random.default_rng(2).random((2, 35, 35, 3), dtype=np.float32)
    t = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    for port, jx in ((inc.avg_pool3, jax_inc._avg_pool3), (inc.max_pool3s2, jax_inc._max_pool3s2)):
        got = port(t).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, np.asarray(jx(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["A", "B", "C", "D", "E"])
def test_inception_blocks_match_jax(name):
    """Each mixed block on a (2, 11, 13, 16) input, its branches concatenated
    in the JAX package's order."""
    cin = 16
    port, jx = {
        "A": (inc.InceptionA(cin, 32), jax_inc.InceptionA(32)),
        "B": (inc.InceptionB(cin), jax_inc.InceptionB()),
        "C": (inc.InceptionC(cin, 24), jax_inc.InceptionC(24)),
        "D": (inc.InceptionD(cin), jax_inc.InceptionD()),
        "E": (inc.InceptionE(cin), jax_inc.InceptionE()),
    }[name]
    state = random_state(port, 3)
    x = np.random.default_rng(4).random((2, 11, 13, cin), dtype=np.float32)
    got, want = port_apply(port, state, x), jax_apply(jx, state, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def jax_features(params, x_nchw):
    apply = jax_fid._shared_inception_apply(jnp.float32)
    return np.asarray(apply(params, jnp.asarray(x_nchw.transpose(0, 2, 3, 1))))


def assert_features_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < FEATURE_RTOL, err


def test_features_match_jax_with_fallback_weights():
    """The whole network on 2 images at 299, the fallback weights on both
    sides."""
    state = inc.init_feature_weights(0)
    x = golden.inputs(5, n=2)
    got = FeatureExtractor(device="cpu")(x)
    assert_features_close(got, jax_features(jax_inc.convert_torch_state_dict(state), x))


def test_pxd_backbone_matches_jax():
    """``stats/inception_pxd.msgpack`` read by the port's reader and mapped by
    ``inception_state_from_flax`` gives the JAX ``FeatureExtractor``'s
    features (2 images)."""
    x = golden.inputs(6, n=2)
    got = FeatureExtractor(PXD, device="cpu")(x)
    want = jax_fid.FeatureExtractor(weights_path=PXD)(x.transpose(0, 2, 3, 1))
    assert_features_close(got, want)
    assert np.abs(want).max() > 100  # the trained backbone, not the fallback


def test_flax_and_torch_state_dicts_map_and_refuse():
    """The flax tree maps onto every module key and round-trips through the
    JAX package's inverse; a torchvision-style dict loads as is, its head and
    counters dropped; a missing or unused key raises."""
    tree = read_checkpoint(PXD)
    state = inc.inception_state_from_flax(tree)
    assert set(state) == set(inc.InceptionV3Features().state_dict())
    back = inc.inception_state_from_flax(jax_inc.convert_torch_state_dict(state))
    assert all(np.array_equal(back[k], v) for k, v in state.items())

    tv = dict(state, **{"fc.weight": np.zeros((40, 2048), np.float32),
                        "AuxLogits.fc.bias": np.zeros(40, np.float32),
                        "Mixed_5b.branch1x1.bn.num_batches_tracked": np.array(3)})
    assert set(inc.inception_state_from_torch(tv)) == set(state)
    with pytest.raises(KeyError, match="lack"):
        inc.inception_state_from_torch({k: v for k, v in state.items() if "Mixed_7c" not in k})
    with pytest.raises(KeyError, match="lack"):
        inc.inception_state_from_flax({k: v for k, v in tree.items() if k != "Mixed_5b"})
    with pytest.raises(KeyError, match="fits no"):
        inc.inception_state_from_flax(dict(tree, extra={"head": np.zeros(3)}))


def build_golden(seed: int = 0) -> dict:
    """The JAX package's features for the golden inputs and fallback weights."""
    params = jax_inc.convert_torch_state_dict(inc.init_feature_weights(seed))
    feats = jax_features(params, golden.inputs(seed))
    index = golden.entry_index(seed)
    return {"seed": seed, "weights": f"ieagan_torch.eval.inception.init_feature_weights({seed})",
            "index": index.tolist(), **golden.summarize(feats, index)}


def test_golden_file_matches_jax_and_port():
    """The file holds what the JAX package computes now (9 significant
    digits), the port on the CPU is within its bounds, and the control (the
    same weights on the other half of the images) breaks both."""
    g = golden.load()
    fresh = build_golden(g["seed"])
    assert fresh["index"] == g["index"]
    for key in ("norm", "entries"):
        np.testing.assert_allclose(fresh[key], g[key], rtol=1e-7, atol=1e-9)
    feats = FeatureExtractor(device="cpu")(golden.inputs(g["seed"]))
    result = golden.compare(g, feats)
    assert result["norm_ok"] and result["entry_ok"], result
    half = golden.N_IMAGES // 2
    control = golden.compare(g, feats[half:], images=np.arange(half))
    assert not control["norm_ok"] and not control["entry_ok"], control


if __name__ == "__main__":
    if "--write" not in sys.argv:
        raise SystemExit("usage: PYTHONPATH=. python tests/test_torch_inception.py --write")
    jax.config.update("jax_platforms", "cpu")
    data = build_golden(0)
    data = {k: ([float(f"{x:.9g}") for x in v] if k in ("norm", "entries") else v)
            for k, v in data.items()}
    with open(golden.GOLDEN_PATH, "w", encoding="utf-8") as fp:
        json.dump(data, fp)
    print(f"wrote {golden.GOLDEN_PATH}")
