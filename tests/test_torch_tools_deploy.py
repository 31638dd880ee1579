"""``python -m ieagan_torch.deploy.create_gan_digits`` (the twin of
``physics_analysis/create_gan_digits.py``) at tiny size on the CPU: the
checkpoint resolution equals the JAX package's on one weights dir; the
CLI's sha256 line names the resolved file's digest; its npz shards equal
``produce_events`` on the same model and seed, and with basf2 (faked as in
``tests/test_deploy.py``) it feeds the basf2 loop. Every user tool of the
port refuses to run without a CUDA device unless asked for the CPU."""

import hashlib
import json

import numpy as np
import pytest
import torch

from ieagan_tpu.deploy.inference import resolve_generator_checkpoint as jax_resolve
from ieagan_torch.deploy import Model, create_gan_digits
from ieagan_torch.deploy import producer as prod
from ieagan_torch.eval import finetune_inception, kid_eval, mint_stats, moments_check
from ieagan_torch.models.convert import generator_state_to_flax
from ieagan_torch.train import dynamics_compare, physics_ab
from ieagan_torch.utils.flax_msgpack import msgpack_serialize, resolve_generator_checkpoint
from tests.test_deploy import _install_fake_basf2
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse fixture)

CFG = dict(resolution=32, n_classes=4, H_base=1, G_ch=4, G_depth=1, G_attn="0",
           use_pallas_attention=False)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A weights dir in the driver's layout: G_ema and G at copy2 and copy4
    (copy4 the newest by itr), G_ema at best0, G alone at copy6 (older by
    itr than copy4), each from its own seed."""
    wdir = tmp_path_factory.mktemp("weights")
    files = {("G_ema", "copy2"): 1, ("G", "copy2"): 2, ("G_ema", "copy4"): 3, ("G", "copy4"): 4,
             ("G_ema", "best0"): 5, ("G", "copy6"): 6}
    for (base, tag), seed in files.items():
        G = Model(config=CFG, device="cpu", seed=seed).G
        (wdir / f"{base}_{tag}.msgpack").write_bytes(msgpack_serialize(
            generator_state_to_flax(G)))
    for tag, itr in (("copy2", 2), ("copy4", 4), ("copy6", 3), ("best0", 4)):
        (wdir / f"state_dict_{tag}.json").write_text(json.dumps({"itr": itr}))
    return wdir


@pytest.mark.parametrize("tag,use_ema", [(None, True), ("copy2", True), ("best0", True),
                                         ("copy6", True), ("copy4", False), (None, False),
                                         ("file", True)])
def test_resolution_equals_jax(weights, tag, use_ema):
    path = str(weights)
    if tag == "file":
        path, tag = str(weights / "G_copy2.msgpack"), None
    got = resolve_generator_checkpoint(path, tag=tag, use_ema=use_ema)
    assert got == jax_resolve(path, tag=tag, use_ema=use_ema)
    if tag == "copy6":
        assert got.endswith("G_copy6.msgpack")  # no G_ema at copy6: G
    if tag is None and path == str(weights):
        assert got.endswith(("G_ema_copy4.msgpack" if use_ema else "G_copy4.msgpack"))


def test_resolution_refuses_a_missing_tag_as_jax(weights):
    for resolve in (resolve_generator_checkpoint, jax_resolve):
        with pytest.raises(FileNotFoundError, match="copy8"):
            resolve(str(weights), tag="copy8")


def test_cli_shards_equal_produce_events(weights, tmp_path, monkeypatch, capsys):
    """3 events at 1 a call: the shard holds what ``produce_events`` writes
    for ``Model.restore`` of the same file and seed; the sha256 line is the
    resolved file's digest."""
    monkeypatch.setenv("IEAGAN_PLATFORM", "cpu")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CFG))
    out = tmp_path / "cli"
    n = create_gan_digits.main([str(out), "3", "--checkpoint", str(weights), "--tag", "best0",
                                "--config", str(cfg), "--events-per-call", "1", "--seed", "5"])
    lines = capsys.readouterr().out.splitlines()
    path = weights / "G_ema_best0.msgpack"
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    assert lines[0] == f"checkpoint G_ema_best0.msgpack sha256: {digest}"
    assert lines[-1] == f"produced 3 events -> {out}" and n == 3
    model = Model.restore(str(path), config=CFG, device="cpu")
    assert prod.produce_events(model, 3, out_dir=str(tmp_path / "api"), events_per_call=1,
                               seed=5) == 3
    got, want = np.load(out / "events_00000.npz"), np.load(tmp_path / "api" / "events_00000.npz")
    assert sorted(got.files) == sorted(want.files) and int(got["n_events"]) == 3
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key])
    assert sum(len(got[f"charges_{i}"]) for i in range(3)) > 0


def test_cli_without_checkpoint_feeds_basf2(tmp_path, monkeypatch, capsys):
    """No checkpoint: ``Model(config)`` from its seed, no sha256 line; with
    basf2 importable the digits go to the basf2 loop, not to shards."""
    monkeypatch.setenv("IEAGAN_PLATFORM", "cpu")
    store_cls = _install_fake_basf2(monkeypatch)
    store_cls.instances.clear()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CFG))
    assert create_gan_digits.main([str(tmp_path / "out"), "2", "--config", str(cfg),
                                   "--events-per-call", "1"]) == 2
    out = capsys.readouterr().out
    assert "sha256" not in out and "produced 2 events" in out
    (store,) = store_cls.instances
    want = list(prod.EventProducer(Model(config=CFG, device="cpu"), num_events=2,
                                   events_per_call=1).start())
    assert len(store.slots) == sum(len(c) for c, _ in want)
    assert not (tmp_path / "out" / "events_00000.npz").exists()


TOOLS = {
    "create_gan_digits": (create_gan_digits.main, ["out", "1"]),
    "mint_stats": (mint_stats.main, ["name", "dir"]),
    "kid_eval": (kid_eval.main, ["--run-dir", "run", "--tag", "best0"]),
    "moments_check": (moments_check.main, ["--run-dir", "run", "--tag", "best0"]),
    "finetune_inception": (finetune_inception.main, ["--dataroot", "data"]),
    "physics_ab": (physics_ab.main, ["arm"]),
    "dynamics_compare": (dynamics_compare.main, ["ours", "--dataroot", "d", "--outputroot", "o"]),
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_needs_the_gpu_unless_asked_for_the_cpu(tool, monkeypatch, tmp_path):
    """Without a CUDA device and without ``IEAGAN_PLATFORM=cpu`` (or the
    tool's ``--cpu``), each tool exits with an error before it reads a file."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("IEAGAN_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = TOOLS[tool]
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv)
    monkeypatch.setenv("IEAGAN_PLATFORM", "gpu")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv)
    assert not list(tmp_path.iterdir())
