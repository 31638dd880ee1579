"""``python -m ieagan_torch.eval.compare`` (the twin of ``scripts/eval_all.py``)
at tiny size on the CPU: a run dir through ``Model.restore`` and a reference
``.pth`` through ``Model.from_torch``, each with its ablation's overrides; the
stats under the keys of the JAX package's physics evaluation; the pickle the
CLI writes."""

import json
import pickle

import numpy as np
import pytest
import torch

from ieagan_tpu.eval import physics as jphysics
from ieagan_torch.deploy import Model
from ieagan_torch.eval import compare
from ieagan_torch.models.convert import generator_state_to_flax
from ieagan_torch.utils.flax_msgpack import msgpack_serialize
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401

TINY = {k: v for k, v in tiny_config(compute_dtype="float32").items()
        if k in ("resolution", "G_ch", "G_depth", "H_base", "n_classes", "use_pallas_attention")}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """An IEAGAN run dir (G_ema at copy2 and copy4, the newest is read) and a
    PEGAN .pth, from random inits."""
    root = tmp_path_factory.mktemp("compare")
    run = root / "run"
    run.mkdir()
    for itr, seed in ((2, 1), (4, 2)):
        G = Model(config=TINY, device="cpu", seed=seed).G
        (run / f"G_ema_copy{itr}.msgpack").write_bytes(msgpack_serialize(
            generator_state_to_flax(G)))
        (run / f"state_dict_copy{itr}.json").write_text(json.dumps({"itr": itr}))
    pegan = Model(config=dict(TINY, **compare.ABLATION_OVERRIDES["PEGAN"]), device="cpu", seed=3)
    pth = pegan.export_torch(str(root / "pegan.pth"))
    return run, pth, Model(config=TINY, device="cpu", seed=2), pegan


def test_load_model_applies_the_ablation(weights):
    run, pth, ieagan, pegan = weights
    a = compare.load_model("IEAGAN", str(run), TINY, device="cpu")
    assert a.config["RRM_prx_G"] and hasattr(a.G, "RR_G")
    for name, value in ieagan.G.state_dict().items():
        assert torch.equal(a.G.state_dict()[name], value), name
    b = compare.load_model("PEGAN", pth, TINY, device="cpu")
    assert not hasattr(b.G, "RR_G") and hasattr(b.G, "attn_2") and b.config["G_attn"] == "32"
    for name, value in pegan.G.state_dict().items():
        assert torch.equal(b.G.state_dict()[name], value), name


def test_cli_writes_the_stats_pickle(weights, tmp_path, few_torch_threads):  # noqa: F811
    run, pth, _, pegan = weights
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY))
    out = tmp_path / "stats.pickle"
    compare.main(["--out", str(out), "--model", f"IEAGAN:{run}", "--model", f"PEGAN:{pth}",
                  "--n-events", "2", "--device", "cpu", "--config", str(cfg)])
    with open(out, "rb") as fp:
        stats = pickle.load(fp)
    labels = np.arange(4)
    jax_keys = set(jphysics.get_stats(iter([(np.ones((4, 26, 32)) * 9, labels)]), 1))
    assert set(stats) == {"IEAGAN", "PEGAN"}
    for name, s in stats.items():
        assert set(s) == jax_keys and s["n_events"] == 2, name
        assert s["intensity_hist"].sum() == 2 * 4 * 26 * 32
    host = compare.compare([f"PEGAN:{pth}"], n_events=2, host_stats=True, device="cpu",
                           config=TINY)["PEGAN"]
    np.testing.assert_array_equal(host["intensity_hist"], stats["PEGAN"]["intensity_hist"])
    np.testing.assert_allclose(host["per_sensor_occupancy"], stats["PEGAN"]["per_sensor_occupancy"])
