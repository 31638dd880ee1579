"""The A/B harnesses (``python -m ieagan_torch.train.physics_ab``, twin of
``scripts/physics_ab.py``; ``.dynamics_compare ours``, the ``ours`` arm of
``scripts/dynamics_compare.py``) and the readers that need no twin
(``scripts/campaign_report.py``, ``scripts/plot_physics.py``) on files the
port writes, at tiny size on the CPU.

* An arm's driver config is the JAX harness's merge (``:196-213``) of the
  JAX modules' own ``BASE_OVERRIDES`` and ``DEFAULT_CONFIG`` (read, not
  run); ``dynamics_compare ours`` builds the JAX ``OVERRIDES`` merge
  (``:76-81``); ``ref`` exits naming the missing reference code.
* One arm of one step at tiny widths, logging every step (``--overrides``), 4 sensors of 58x64
  minted by ``scripts/make_synthetic_dataset.py``: its JSON line has the JAX
  harness's keys (read from its source), ``backend`` ``cpu``, and is
  appended to ``--out``; a missing split is refused with the command that
  mints it.
* ``campaign_report.py`` summarises the arm's run dir; ``plot_physics.py``
  renders (Agg) from ``python -m ieagan_torch.eval.compare``'s pickle of the
  arm's generator and the test split.
"""

import argparse
import ast
import contextlib
import importlib.util
import io
import json
import math
import os
import subprocess
import sys

import pytest

from ieagan_tpu.core.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from ieagan_torch.train import dynamics_compare, physics_ab
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"G_ch": 4, "D_ch": 4, "G_depth": 2, "D_depth": 2, "n_classes": 4, "G_attn": "0",
        "D_attn": "0", "events_per_batch": 1}
# the arm's lever: tiny widths, every step's metrics and singular values logged
ARM = dict(TINY, log_interval=1, sv_log_interval=1)


def script(name: str):
    """A script of ``scripts/`` as a module, its ``main`` not run."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_arm_config_is_the_jax_harness_merge():
    jax_ab = script("physics_ab")
    assert physics_ab.BASE_OVERRIDES == jax_ab.BASE_OVERRIDES
    for overrides, steps, events in (({}, 2000, 1200), ({"events_per_batch": 3}, 700, 1200),
                                     (TINY, 1, 2)):
        # scripts/physics_ab.py:196-213
        want = dict(JAX_DEFAULT_CONFIG)
        want.update(jax_ab.BASE_OVERRIDES)
        want.update(overrides)
        spe = max(1, events // int(want.get("events_per_batch", 1)))
        want.update(dataroot="tr", outputroot=os.path.join("root", "runs"), run_name="arm",
                    num_epochs=max(1, math.ceil(steps / spe)), stop_after=steps,
                    save_every=steps, resume=True)
        assert physics_ab.arm_config("arm", overrides, steps, "tr", "root", events) == want


def test_dynamics_ours_builds_the_jax_overrides(tmp_path):
    jax_dyn = script("dynamics_compare")
    assert dynamics_compare.OVERRIDES == jax_dyn.OVERRIDES
    args = argparse.Namespace(dataroot="d", outputroot="o", run_name="dyn64_ours", steps=15,
                              epochs=2)
    # scripts/dynamics_compare.py:76-81
    want = dict(JAX_DEFAULT_CONFIG)
    want.update(jax_dyn.OVERRIDES)
    del want["device"]
    want.update(dataroot="d", outputroot="o", run_name="dyn64_ours", num_epochs=2,
                stop_after=15, use_pallas_attention=False)
    assert dynamics_compare.ours_config(args) == want
    with pytest.raises(SystemExit, match="not in this repository"):
        dynamics_compare.main(["ref", "--dataroot", "d", "--outputroot", str(tmp_path)])


def _mint(split_dir, events, event_seed=None):
    cmd = [sys.executable, os.path.join(REPO, "scripts", "make_synthetic_dataset.py"),
           str(split_dir), "--events", str(events), "--sensors", "4", "--height", "58",
           "--width", "64", "--seed", "0"]
    subprocess.run(cmd + (["--event-seed", str(event_seed)] if event_seed else []), check=True,
                   capture_output=True)


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    """One tiny arm of one step through ``physics_ab.main`` on the CPU."""
    root = tmp_path_factory.mktemp("ab64")
    _mint(root / "train", 2)
    _mint(root / "test", physics_ab.TEST_EVENTS, physics_ab.TEST_EVENT_SEED)
    mp = pytest.MonkeyPatch()
    mp.setenv("IEAGAN_PLATFORM", "cpu")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            results = physics_ab.main(["tiny", "--steps", "1", "--overrides", json.dumps(ARM),
                                       "--root", str(root), "--train-events", "2",
                                       "--eval-events", "2"])
    finally:
        mp.undo()
    return root, results, out.getvalue()


def _jax_result_keys() -> list:
    """The keys of ``result`` in ``scripts/physics_ab.py::_run_arm``."""
    with open(os.path.join(REPO, "scripts", "physics_ab.py"), encoding="utf-8") as fp:
        tree = ast.parse(fp.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "result"
                and isinstance(node.value, ast.Dict)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no result dict in scripts/physics_ab.py")


def test_arm_prints_the_jax_keys(arm):
    root, results, out = arm
    (result,) = results
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == _jax_result_keys() and line == result
    assert line["backend"] == "cpu" and line["steps"] == 1 and line["variant"] == "tiny"
    assert line["overrides"] == ARM and line["eval_events"] == 2
    assert 0 < line["occupancy_real"] and line["occupancy_gan"] >= 0
    with open(root / "physics_ab.jsonl", encoding="utf-8") as fp:
        assert [json.loads(ln) for ln in fp] == [line]
    assert (root / "runs" / "tiny" / "weights" / "state_dict_copy1.json").exists()


def test_missing_split_says_how_to_mint_it(tmp_path, monkeypatch):
    monkeypatch.setenv("IEAGAN_PLATFORM", "cpu")
    args = argparse.Namespace(train_root=str(tmp_path / "train"), train_events=5,
                              test_root=str(tmp_path / "test"))
    with pytest.raises(SystemExit, match=r"scripts/make_synthetic_dataset.py .*--events 5 "
                                         r"--sensors 40 --height 58 --width 64 --seed 0$"):
        physics_ab.run_arm(args, "x", {}, 1, None)


def test_campaign_report_reads_a_port_run_dir(arm, monkeypatch, capsys):
    root, _, _ = arm
    report = script("campaign_report")
    monkeypatch.setattr(sys, "argv", ["campaign_report.py", str(root / "runs" / "tiny")])
    report.main()
    out = json.loads(capsys.readouterr().out)
    assert set(out["losses"]) >= {"G_loss", "D_loss_real", "D_loss_fake"}
    assert out["sec_per_itr"]["n_logged"] >= 1
    assert {"G", "D"} <= set(out["sv"])


def test_plot_physics_renders_the_compare_pickle(arm, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    from ieagan_torch.eval import compare
    root, _, _ = arm
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(TINY, resolution=64, H_base=1, use_pallas_attention=False)))
    pkl = tmp_path / "stats.pickle"
    compare.main(["--out", str(pkl), "--model", f"IEAGAN:{root / 'runs' / 'tiny' / 'weights'}",
                  "--dataroot", str(root / "test"), "--n-events", "2", "--device", "cpu",
                  "--config", str(cfg)])
    plots = script("plot_physics")
    monkeypatch.setattr(sys, "argv", ["plot_physics.py", str(pkl), "--out",
                                      str(tmp_path / "figures")])
    plots.main()
    figures = sorted(os.listdir(tmp_path / "figures"))
    assert figures and all(f.endswith((".png", ".pdf")) for f in figures)
