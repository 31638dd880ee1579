"""The port's samplers, sheets, standing stats, logs and plots (twins of
``ieagan_tpu/utils``), held to the contracts ``tests/test_utils_extra.py``
holds the JAX package's to, and the log files to the JAX package's readers.
Samplers draw from a ``torch.Generator``, so values differ from JAX's keys;
shapes, ranges and invariants are exact."""

import numpy as np
import pytest
import torch

from ieagan_tpu.utils import read_jsonl as jax_read_jsonl
from ieagan_tpu.utils import read_metric_log as jax_read_metric_log
from ieagan_torch.models.generator import Generator
from ieagan_torch.utils.log_read import read_metric_log, sv_spectra
from ieagan_torch.utils.logging import Logger, MetricsLogger
from ieagan_torch.utils.plot import cosine_similarity_matrix, plot_imgs, plot_sim_heatmap
from ieagan_torch.utils.sampling import (accumulate_standing_stats, generate_images, interp,
                                         interp_sheet, sample_sheet, sample_y, sample_z,
                                         trunc_trick)
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)

CFG = tiny_config(compute_dtype="float32")


@pytest.fixture(scope="module")
def tiny_g():
    G = Generator.from_config(CFG)
    G.reset_parameters(torch.Generator().manual_seed(0))
    return G.eval()


def test_samplers():
    gen = torch.Generator().manual_seed(0)
    assert sample_z(gen, 64, 16, "normal").shape == (64, 16)
    assert float(sample_z(gen, 64, 16, "censored_normal").min()) >= 0.0
    assert set(np.unique(sample_z(gen, 64, 16, "bernoulli").numpy())) <= {0.0, 1.0}
    assert float(sample_z(gen, 64, 16, "truncated_normal", threshold=0.7).abs().max()) <= 0.7
    assert float(trunc_trick(gen, (500,), bound=0.5).abs().max()) <= 0.5
    y = sample_y(gen, 40, events=3, y_dist="permuted")
    assert y.shape == (120,) and y.dtype == torch.int64
    for e in range(3):
        np.testing.assert_array_equal(np.sort(y[e * 40:(e + 1) * 40].numpy()), np.arange(40))
    assert int(sample_y(gen, 5, 2, "categorical").max()) < 5
    with pytest.raises(NotImplementedError):
        sample_z(gen, 2, 2, "uniform")
    out = interp(torch.zeros((2, 3)), torch.ones((2, 3)), 3)
    assert out.shape == (2, 5, 3)
    np.testing.assert_allclose(out[:, 2].numpy(), 0.5)


def test_sheets_and_images(tiny_g, tmp_path):
    gen = torch.Generator().manual_seed(1)
    es, h, w = CFG["n_classes"], CFG["resolution"] - 6, CFG["resolution"] * CFG["H_base"]
    before = {k: v.clone() for k, v in tiny_g.state_dict().items()}
    tiny_g.train()
    sheets = sample_sheet(tiny_g, CFG, gen, samples_per_class=2)
    assert tiny_g.training  # the mode is restored, and no stat moved
    assert all(torch.equal(v, before[k]) for k, v in tiny_g.state_dict().items())
    tiny_g.eval()
    assert sheets.shape == (es, 2, h, w) and 0.0 <= sheets.min() and sheets.max() <= 255.0
    assert interp_sheet(tiny_g, CFG, gen, num_midpoints=2).shape == (es, 4, h, w)
    assert generate_images(str(tmp_path), tiny_g, dict(CFG, trunc_z=0.5), gen, n_images=6) == 6
    assert len(list(tmp_path.glob("image_*.png"))) == 6


def test_accumulate_standing_stats(tiny_g):
    """The batch-norm stats become sums over the accumulations with their
    counters, the spectral-norm vectors keep their values."""
    import copy
    G = copy.deepcopy(tiny_g)
    spectral = {k: v.clone() for k, v in G.state_dict().items() if k.endswith((".u", ".sv"))}
    accumulate_standing_stats(G, CFG, torch.Generator().manual_seed(2), num_accumulations=3)
    assert not G.training
    sd = G.state_dict()
    counters = [v for k, v in sd.items() if k.endswith("accumulation_counter")]
    assert counters and all(float(c) == 3.0 for c in counters)
    assert all(torch.equal(sd[k], v) for k, v in spectral.items())
    assert not torch.equal(sd["output_bn.mean"], tiny_g.state_dict()["output_bn.mean"])


def test_logs_read_by_both_packages(tmp_path):
    cfg = {"outputroot": str(tmp_path), "run_name": "r", "metric_log_name": "m.jsonl"}
    (tmp_path / "r" / "logs").mkdir(parents=True)
    log = Logger(cfg)
    log.log(10, G_loss=1.5, G_blocks_0_0_conv1_sv=2.5)
    log.log(20, G_loss=1.25)
    path = tmp_path / "r" / "logs" / "G_loss.log"
    assert path.read_text() == "10: 1.500e+00\n20: 1.250e+00\n"
    for read in (read_metric_log, jax_read_metric_log):
        itrs, vals = read(path)
        np.testing.assert_array_equal(itrs, [10, 20])
        np.testing.assert_allclose(vals, [1.5, 1.25])
    assert list(sv_spectra(tmp_path / "r" / "logs")) == ["G_blocks_0_0_conv1_sv"]
    MetricsLogger(cfg).log(itr=1, FID=42.0)
    rec = jax_read_jsonl(tmp_path / "r" / "logs" / "m.jsonl")[0]
    assert rec["FID"] == 42.0 and "_stamp" in rec


def test_plots(tmp_path, monkeypatch, capsys):
    np.testing.assert_allclose(cosine_similarity_matrix(np.eye(4)), np.eye(4), atol=1e-12)
    sim = plot_sim_heatmap(np.random.RandomState(0).randn(8, 16), str(tmp_path / "h.jpg"))
    assert (tmp_path / "h.jpg").exists() and sim.shape == (8, 8)
    imgs = np.random.RandomState(1).uniform(0, 255, (6, 10, 12))
    plot_imgs(imgs, tmp_path / "sheet.jpg", ncol=3)
    assert (tmp_path / "sheet.jpg").exists()
    # without matplotlib: the same images as one plain uint8 grid, said so
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    plot_imgs(imgs, tmp_path / "grid.png", ncol=3)
    from PIL import Image
    grid = np.asarray(Image.open(tmp_path / "grid.png"))
    assert grid.shape == (20, 36)
    np.testing.assert_array_equal(grid[10:20, 12:24], imgs[4].astype(np.uint8))
    assert "matplotlib unavailable" in capsys.readouterr().out


def test_samplers_draw_on_the_generators_device():
    """With ``device=None`` the samplers draw on the ``torch.Generator``'s
    device: a CPU generator gives CPU tensors."""
    from ieagan_torch.ops.diff_aug import sample_diff_aug_draws
    gen = torch.Generator().manual_seed(0)
    outs = [trunc_trick(gen, (3, 4)), sample_z(gen, 2, 3), sample_y(gen, 4, 2),
            *sample_diff_aug_draws(gen, 2, 8, 8).values()]
    assert all(t.device.type == "cpu" for t in outs)


def test_samplers_without_generator_ask_for_cuda():
    """With neither a generator nor a device the samplers draw on the GPU
    (the port runs on the CPU only when asked): under a fake tensor mode the
    draws are CUDA tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ieagan_torch.ops.diff_aug import sample_diff_aug_draws
    with FakeTensorMode():
        outs = [trunc_trick(None, (3, 4)), sample_z(None, 2, 3), sample_y(None, 4, 2),
                *sample_diff_aug_draws(None, 2, 8, 8).values()]
        assert all(t.device.type == "cuda" for t in outs)
