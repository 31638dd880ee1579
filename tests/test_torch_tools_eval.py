"""The port's FID/KID tools at tiny size on the CPU, against the JAX
package's scripts: ``python -m ieagan_torch.eval.mint_stats`` (twin of
``scripts/mint_stats.py``), ``.kid_eval`` (``scripts/kid_eval.py``) and
``.moments_check`` (``scripts/moments_check.py``).

* ``mint_stats`` on a small PNG tree writes the ``.npz`` files the JAX
  package's ``make_custom_stats``/``make_custom_kid_stats`` write with the
  same extractor weights: the port's fallback weights, written as
  ``inception_pxd.msgpack`` through the port's flax writer, which both
  packages' ``default_extractor()`` load (mu, sigma and features within
  1e-4 relative to the largest entry).
* The proof tools' arithmetic equals the JAX scripts' (``frechet_distance``
  on host f64 ``np.cov``, ``kernel_distance``, ``kid_self_floor``) on the
  same seeded features: equal numbers.
* ``kid_eval`` and ``moments_check`` on a tiny run dir, the extractor a 16-d
  stand-in (a 2048-d ``sqrtm`` costs ~20 s of host time each): the JSON
  keys of the JAX scripts' lines (read from their source), G_ema iff the
  run keeps and uses EMA, else G, computing in bfloat16; ``kid_eval``'s FID
  equals ``moments_check``'s host FID (the same seed, images and host path)
  within 1e-6 relative, and the device moments' FID within 1e-4.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ieagan_tpu.eval import fid as jax_fid
from ieagan_torch.eval import fid, kid_eval, mint_stats, moments_check
from ieagan_torch.eval.inception import inception_state_to_flax, init_feature_weights
from ieagan_torch.models.convert import generator_state_to_flax
from ieagan_torch.models.generator import Generator
from ieagan_torch.utils.flax_msgpack import msgpack_serialize
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_ranks import PooledExtractor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_line_keys(script: str) -> list:
    """The keys of the dict the JAX script's ``main`` prints with
    ``json.dumps``, read from its source."""
    with open(os.path.join(REPO, "scripts", script), encoding="utf-8") as fp:
        tree = ast.parse(fp.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no json.dumps of a dict in {script}")


def _png_tree(root, sensors=2, events=3, shape=(40, 52)):
    rng = np.random.default_rng(3)
    for s in range(sensors):
        (root / f"sensor_{s}").mkdir(parents=True)
        for e in range(events):
            img = np.where(rng.random(shape) < 0.2, rng.integers(7, 255, shape), 0)
            Image.fromarray(img.astype(np.uint8)).save(root / f"sensor_{s}" / f"event_{e}.png")
    return root


def test_mint_stats_equals_jax(tmp_path, monkeypatch, capsys):
    tree = _png_tree(tmp_path / "pngs")
    backbone = msgpack_serialize(inception_state_to_flax(init_feature_weights(0)))
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "inception_pxd.msgpack").write_bytes(backbone)
    monkeypatch.setenv("IEAGAN_STATS_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jax_fid, "STATS_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(fid, "_EXTRACTORS", {})
    paths = mint_stats.main(["tree", str(tree), "--num", "5", "--cpu"])
    captured = capsys.readouterr()
    assert f"extractor: {tmp_path / 'port' / 'inception_pxd.msgpack'}" in captured.err
    assert set(paths) == {"fid", "kid"} and "KID stats -> " in captured.out
    extractor = jax_fid.default_extractor()
    assert extractor.source == str(tmp_path / "jax" / "inception_pxd.msgpack")
    want = {"fid": jax_fid.make_custom_stats("tree", str(tree), num=5, extractor=extractor,
                                             resize_on_device=True),
            "kid": jax_fid.make_custom_kid_stats("tree", str(tree), num=5, extractor=extractor,
                                                 resize_on_device=True)}
    for kind in ("fid", "kid"):
        assert os.path.basename(paths[kind]) == os.path.basename(want[kind])
        got, ref = np.load(paths[kind]), np.load(want[kind])
        assert sorted(got.files) == sorted(ref.files)
        for key in ref.files:
            assert got[key].shape == ref[key].shape and got[key].dtype == ref[key].dtype, key
            scale = np.abs(ref[key]).max()
            assert np.abs(got[key] - ref[key]).max() < 1e-4 * scale, key
    assert np.load(paths["kid"])["feats"].shape == (5, 2048)
    with pytest.raises(FileExistsError):
        mint_stats.main(["tree", str(tree), "--num", "5", "--cpu", "--no-kid"])
    mint_stats.main(["tree", str(tree), "--num", "4", "--cpu", "--no-kid", "--overwrite",
                     "--host-resize"])
    assert np.load(paths["fid"])["sigma"].shape == (2048, 2048)


def test_proof_arithmetic_equals_the_jax_scripts():
    """``kid_eval``'s FID, KID and floor on seeded features: the numbers of
    ``scripts/kid_eval.py:93-103`` computed by the JAX package."""
    rng = np.random.default_rng(5)
    feats = (rng.standard_normal((120, 24)) * rng.random(24) + 0.2).astype(np.float32)
    ref = (rng.standard_normal((90, 24)) * rng.random(24)).astype(np.float32)
    ref_mu, ref_sigma = ref.mean(0).astype(np.float64), np.cov(ref.astype(np.float64),
                                                               rowvar=False)
    f64 = feats.astype(np.float64)
    want = jax_fid.frechet_distance(f64.mean(0), np.cov(f64, rowvar=False), ref_mu, ref_sigma)
    assert kid_eval.host_fid(feats, ref_mu, ref_sigma) == want
    for seed in (0, 4):
        assert (fid.kernel_distance(feats.astype(np.float32), ref, seed=seed)
                == jax_fid.kernel_distance(feats.astype(np.float32), ref, seed=seed))
        assert fid.kid_self_floor(ref, seed=seed) == jax_fid.kid_self_floor(ref, seed=seed)


CFG = tiny_config(compute_dtype="float32", fid_dataset_name="tiny", fid_gen_chunks=1, seed=6)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny run dir (config, G and G_ema at best0 from different seeds) and
    a stats dir with 16-d FID and KID stats of dataset ``tiny``."""
    root = tmp_path_factory.mktemp("proof")
    (root / "weights").mkdir()
    (root / "2020-01-01-00-00-00_config.json").write_text(json.dumps(CFG))
    for name, seed in (("G", 1), ("G_ema", 2)):
        G = Generator.from_config(CFG)
        G.reset_parameters(torch.Generator().manual_seed(seed))
        (root / "weights" / f"{name}_best0.msgpack").write_bytes(msgpack_serialize(
            generator_state_to_flax(G)))
    stats = root / "stats"
    stats.mkdir()
    ref = np.random.default_rng(1).random((40, 16)).astype(np.float32)
    np.savez_compressed(stats / "tiny_clean_custom_na.npz", mu=ref.mean(0),
                        sigma=np.cov(ref.astype(np.float64), rowvar=False))
    np.savez_compressed(stats / "tiny_clean_custom_na_kid.npz", feats=ref)
    return root


@pytest.fixture
def seen(run_dir, monkeypatch):
    """The 16-d stand-in extractor; records each generator function's G
    and dtype."""
    monkeypatch.setenv("IEAGAN_STATS_DIR", str(run_dir / "stats"))
    monkeypatch.setenv("IEAGAN_PLATFORM", "cpu")
    extractor = PooledExtractor()
    monkeypatch.setattr(fid, "default_extractor", lambda config=None, device="cpu": extractor)
    made = []
    make = fid.make_generator_fn

    def recorded(G, config, **kwargs):
        made.append((G, kwargs))
        return make(G, config, **kwargs)

    monkeypatch.setattr(fid, "make_generator_fn", recorded)
    return made


def _assert_loaded(run_dir, G, name):
    from ieagan_torch.models.convert import generator_state_from_flax
    from ieagan_torch.utils.flax_msgpack import read_checkpoint
    want = generator_state_from_flax(read_checkpoint(run_dir / "weights" / f"{name}_best0.msgpack"),
                                     G.state_dict())
    for k, v in G.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("use_ema", [True, False])
def test_kid_eval_and_moments_check_lines(run_dir, seen, monkeypatch, capsys, use_ema):
    if not use_ema:
        cfg = run_dir / "2020-01-02-00-00-00_config.json"  # the newest config is read
        cfg.write_text(json.dumps(dict(CFG, use_ema=False)))
    try:
        got = kid_eval.main(["--run-dir", str(run_dir), "--tag", "best0", "--num", "12",
                             "--cpu"])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert list(line) == jax_line_keys("kid_eval.py")
        assert line == {k: got[k] for k in line}
        assert line["num"] == 12 and line["dataset"] == "tiny" and line["tag"] == "best0"
        assert np.isfinite([line["fid"], line["kid_x1e3"], line["kid_floor_x1e3"]]).all()
        assert set(got["seconds"]) == {"generation", "features", "sqrtm", "kid"}
        mom = moments_check.main(["--run-dir", str(run_dir), "--tag", "best0", "--num", "12"])
        mline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert list(mline) == jax_line_keys("moments_check.py") and mline == mom
    finally:
        if not use_ema:
            (run_dir / "2020-01-02-00-00-00_config.json").unlink()
    assert mom["num"] == 12
    assert abs(got["fid"] - mom["fid_host_f64"]) <= 1e-6 * abs(mom["fid_host_f64"])
    assert mom["rel_diff"] < 1e-4
    assert len(seen) == 3
    for G, kwargs in seen:
        assert kwargs["dtype"] == torch.bfloat16 and kwargs["chunks"] == 1
        assert kwargs["trunc"] == (CFG["fid_trunc"] if CFG["fid_trunc"] > 0 else None)
        _assert_loaded(run_dir, G, "G_ema" if use_ema else "G")
