"""The port's FID engine (``ieagan_torch/eval/resize.py``, ``fid.py``)
against the JAX package's (``ieagan_tpu/eval``), held to the contracts
``tests/test_eval.py`` holds the JAX package to.

Both sides see the same numpy inputs and, where features enter, the same
Inception weights: the port's fallback ``init_feature_weights(0)``, on the
JAX side through ``convert_torch_state_dict``. Bounds: resize as
``tests/test_eval.py`` (max 5e-3, mean 2e-4 from PIL); distances computed by
the same numpy code are equal; features within 1e-5 of the largest; minted
mu within 1e-5 and sigma within 1e-4 relative (Frobenius) of the JAX
package's. A Fréchet distance at 2048 dims costs a ~20 s
``scipy.linalg.sqrtm`` on an 8-core CPU alone (and minutes under the test run's
six workers), so the end-to-end FID test takes a 16-d stand-in extractor.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ieagan_tpu.eval import fid as jax_fid
from ieagan_tpu.eval.inception import convert_torch_state_dict
from ieagan_tpu.eval.resize import jax_resize_single_channel
from ieagan_tpu.models import Generator as JaxG
from ieagan_torch.eval import fid
from ieagan_torch.eval.inception import init_feature_weights
from ieagan_torch.eval.resize import pil_resize_batch, resize_single_channel
from ieagan_torch.models.convert import generator_state_to_flax
from ieagan_torch.models.generator import Generator
from tests.helpers import tiny_config
from tests.torch_ranks import PooledExtractor  # the 16-d stand-in for Inception


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads while the module runs: the test run's six workers
    with a thread per core each oversubscribe the cores, which slows the
    many small ops of a tiny generator or train step tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class JaxExtractor:
    """The JAX package's extractor interface over given params (its own
    constructor would draw the JAX fallback weights)."""

    def __init__(self, params):
        self.params = params
        self._apply = jax_fid._shared_inception_apply(jnp.float32)

    def __call__(self, images):
        return np.asarray(self._apply(self.params, jnp.asarray(images)))


@pytest.fixture(scope="module")
def extractors():
    port = fid.FeatureExtractor(device="cpu")
    return port, JaxExtractor(convert_torch_state_dict(init_feature_weights(0)))


@pytest.mark.parametrize("interp,scale", [("bilinear", 1.0), ("bicubic", 255.0)])
def test_resize_matches_pil_and_jax(interp, scale):
    x = np.random.RandomState(0).rand(2, 250, 768).astype(np.float32) * scale
    ref = pil_resize_batch(x, interp=interp)
    got = resize_single_channel(torch.from_numpy(x), interp=interp).numpy()
    assert got.shape == ref.shape == (2, 3, 299, 299)
    assert np.abs(got - ref).max() < 5e-3 * scale and np.abs(got - ref).mean() < 2e-4 * scale
    np.testing.assert_array_equal(got[:, 0], got[:, 2])
    jx = np.asarray(jax_resize_single_channel(jnp.asarray(x), interp=interp))
    assert np.abs(got - jx.transpose(0, 3, 1, 2)).max() < 5e-3 * scale
    from ieagan_tpu.eval.resize import pil_resize_batch as jax_pil
    np.testing.assert_array_equal(ref, jax_pil(x, interp=interp).transpose(0, 3, 1, 2))


def test_fid_postprocess_matches_jax():
    imgs = np.random.default_rng(1).uniform(-1, 1, (3, 32, 20, 1)).astype(np.float32)
    imgs[0, 5, 5, 0] = -0.25  # on the threshold: cut
    got = fid.fid_postprocess(torch.from_numpy(imgs)).numpy()
    want = np.asarray(jax_fid.fid_postprocess(jnp.asarray(imgs)))
    assert got.shape == (3, 26, 20)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0, 2, 5] == 0.0


def test_distances_equal_jax():
    """Fréchet distance, KID and the KID floor: the same numbers as the JAX
    package for the same inputs and seed; the f32 eigh variant within 1e-4
    of the host's at d=96."""
    rng = np.random.RandomState(1)
    d, n = 96, 400
    x1 = rng.randn(n, d) * rng.rand(d) * 3
    x2 = rng.randn(n, d) * rng.rand(d) * 2 + 0.3
    mu1, s1, mu2, s2 = x1.mean(0), np.cov(x1, rowvar=False), x2.mean(0), np.cov(x2, rowvar=False)
    host = fid.frechet_distance(mu1, s1, mu2, s2)
    assert host == jax_fid.frechet_distance(mu1, s1, mu2, s2)
    dev = float(fid._frechet_device(*(torch.tensor(a, dtype=torch.float32)
                                      for a in (mu1, s1, mu2, s2))))
    assert abs(dev - host) / host < 1e-4, (host, dev)
    assert fid.frechet_distance(mu1, s1, mu1, s1) == pytest.approx(0.0, abs=1e-6)
    f1, f2 = rng.randn(300, 8), rng.randn(250, 8) + 0.5
    for seed in (0, 3):
        assert (fid.kernel_distance(f1, f2, num_subsets=20, seed=seed)
                == jax_fid.kernel_distance(f1, f2, num_subsets=20, seed=seed))
        assert fid.kid_self_floor(f1, seed=seed) == jax_fid.kid_self_floor(f1, seed=seed)


def test_moments_match_host_cov_2048d():
    """The pilot-centred f32 moments reproduce host f64 ``np.cov`` at 2048
    dims with a realistic non-zero mean (twin of
    ``tests/test_eval.py::test_device_moments_match_host_cov_2048d``)."""
    rng = np.random.RandomState(7)
    d, n, bs = 2048, 1920, 320
    mean = rng.rand(d) * 0.8
    scale = 0.05 + rng.rand(d) * 0.5
    feats = (rng.randn(n, d) * scale + mean).astype(np.float32)
    t = torch.from_numpy(feats)
    acc_s, acc_o = torch.zeros(d), torch.zeros((d, d))
    pilot = t[:bs].mean(0)
    for i in range(0, n, bs):
        fid._moment_update(acc_s, acc_o, t[i:i + bs], pilot)
    s_over_n = acc_s.double().numpy() / n
    mu = pilot.double().numpy() + s_over_n
    sigma = (acc_o.double().numpy() - n * np.outer(s_over_n, s_over_n)) / (n - 1)
    host = feats.astype(np.float64)
    assert np.abs(mu - host.mean(0)).max() < 1e-5
    cov = np.cov(host, rowvar=False)
    assert np.linalg.norm(sigma - cov) / np.linalg.norm(cov) < 1e-4


def _png_tree(root, n=3, seed=3):
    rng = np.random.RandomState(seed)
    root.mkdir()
    for i in range(n):
        Image.fromarray((rng.rand(60, 80) * 255).astype(np.uint8), mode="L").save(root / f"{i}.png")
    return root


def test_make_custom_stats_matches_jax(tmp_path, monkeypatch, extractors):
    """Stats minted from a PNG folder by both packages, the same weights:
    mu and sigma agree; the KID bank holds the folder's features; both
    modes and both resizes run."""
    port, jx = extractors
    folder = _png_tree(tmp_path / "imgs")
    monkeypatch.setenv("IEAGAN_STATS_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jax_fid, "STATS_DIR", str(tmp_path / "jax"))
    got = np.load(fid.make_custom_stats("tiny", str(folder), extractor=port, batch_size=2))
    want = np.load(jax_fid.make_custom_stats("tiny", str(folder), extractor=jx, batch_size=4))
    assert got["sigma"].shape == (2048, 2048)
    np.testing.assert_allclose(got["mu"], want["mu"], rtol=1e-5, atol=1e-6)
    # the covariance of 3 images is a difference of nearly equal features,
    # which amplifies their 1e-6 rounding: 3.4e-5 read here
    assert np.linalg.norm(got["sigma"] - want["sigma"]) / np.linalg.norm(want["sigma"]) < 1e-4
    kid = np.load(fid.make_custom_kid_stats("tiny", str(folder), extractor=port))["feats"]
    with pytest.raises(FileExistsError):
        fid.make_custom_stats("tiny", str(folder), extractor=port)
    a = fid.get_folder_features(str(folder), port, mode="clean")
    np.testing.assert_array_equal(kid, a)
    b = fid.get_folder_features(str(folder), port, mode="clean_255")
    c = fid.get_folder_features(str(folder), port, mode="clean", resize_on_device=True)
    assert a.shape == b.shape == (3, 2048) and np.abs(a - b).max() > 1e-6
    assert np.abs(a - c).max() < 1e-4 * np.abs(a).max()


def test_compute_fid_and_kid_against_tmp_stats(tmp_path, monkeypatch):
    """Twin of ``tests/test_eval.py``'s end-to-end FID and KID: a dummy
    generator against stats minted from its own outputs scores ~0; its
    device moments give the host path's mean, covariance and FID; shifted,
    it scores a higher FID and KID; missing stats raise. The extractor is
    a 16-d stand-in: Inception itself is held to the JAX package above and
    in ``tests/test_torch_inception.py``."""
    monkeypatch.setenv("IEAGAN_STATS_DIR", str(tmp_path))
    port = PooledExtractor()

    def gen_fn(generator):
        return torch.rand((4, 32, 32, 1), generator=generator) * 2 - 1

    def gen_shifted(generator):
        return torch.clamp(gen_fn(generator) + 0.8, -1, 1)

    seeded = lambda s: torch.Generator().manual_seed(s)
    ref = fid.get_model_features(gen_fn, port, num_gen=30, generator=seeded(1))
    assert ref.shape == (30, 16)
    cov = np.cov(ref.astype(np.float64), rowvar=False)
    mu, sigma, n = fid.get_model_features(gen_fn, port, num_gen=30, generator=seeded(1),
                                          return_moments=True)
    assert n == 30 and np.abs(mu - ref.mean(0)).max() < 1e-6
    assert np.linalg.norm(sigma - cov) / np.linalg.norm(cov) < 1e-5
    np.savez_compressed(tmp_path / "selftest_clean_custom_na.npz", mu=ref.mean(0), sigma=cov)
    np.savez_compressed(tmp_path / "selftest_clean_custom_na_kid.npz", feats=ref)
    common = dict(dataset_name="selftest", num_gen=30, extractor=port)
    f_same, feats = fid.compute_fid(gen_fn, generator=seeded(1), return_features=True, **common)
    np.testing.assert_array_equal(feats, ref)
    assert abs(f_same) < 1e-6 * np.trace(cov), f_same
    f_other = fid.compute_fid(gen_fn, generator=seeded(2), **common)
    f_moments = fid.compute_fid(gen_fn, generator=seeded(2), moments_on_device=True, **common)
    assert f_moments == pytest.approx(f_other, rel=1e-4)
    f_shift = fid.compute_fid(gen_shifted, generator=seeded(2), **common)
    assert np.isfinite(f_other) and f_shift > 10 * f_other
    k_same = fid.compute_kid(gen_fn, generator=seeded(2), **common)
    k_shift = fid.compute_kid(gen_shifted, generator=seeded(2), **common)
    assert np.isfinite(k_same) and k_shift > 10 * abs(k_same)
    with pytest.raises(FileNotFoundError):
        fid.get_reference_statistics("nope")
    with pytest.raises(FileNotFoundError):
        fid.compute_kid(gen_fn, dataset_name="nope", extractor=port)
    with pytest.raises(FileNotFoundError):
        fid.compute_fid(gen_fn, dataset_name="nope", extractor=port)
    with pytest.raises(FileNotFoundError):
        fid.FeatureExtractor(str(tmp_path / "absent.msgpack"), device="cpu")


def test_generator_fn_features_match_jax(extractors):
    """``make_generator_fn`` on a tiny G: its output equals the JAX G's on the
    same z, permuted labels and rdof (drawn by ``draw_fid_latents`` from the
    same seed), and ``get_model_features`` of it equals the JAX package's
    postprocess, device resize and features."""
    port, jx = extractors
    cfg = tiny_config(compute_dtype="float32")
    es, epb = cfg["n_classes"], cfg["events_per_batch"]
    G = Generator.from_config(cfg)
    G.reset_parameters(torch.Generator().manual_seed(0))
    gen = fid.make_generator_fn(G, cfg, trunc=1.0, chunks=1)
    imgs = gen(torch.Generator().manual_seed(3)).numpy()
    z, y, rdof = fid.draw_fid_latents(torch.Generator().manual_seed(3), es, epb, cfg["dim_z"],
                                      cfg["rdof_dim"], trunc=1.0, device="cpu")
    assert float(z.abs().max()) <= 1.0
    for e in range(epb):
        np.testing.assert_array_equal(np.sort(y[e * es:(e + 1) * es].numpy()), np.arange(es))

    variables = generator_state_to_flax(G)

    def interceptor(next_fun, args, kwargs, context):
        if context.module.name == "linear_f" and context.method_name == "__call__":
            args = (args[0].at[:, -rdof.shape[1]:].set(jnp.asarray(rdof.numpy())),) + args[1:]
        return next_fun(*args, **kwargs)

    @jax.jit
    def forward(variables, z, y):
        with nn.intercept_methods(interceptor):
            return JaxG.from_config(cfg).apply(variables, z, y, train=False,
                                               rngs={"rdof": jax.random.PRNGKey(0)})

    want = np.asarray(forward({"params": variables["params"], **variables["state"]},
                              jnp.asarray(z.numpy()), jnp.asarray(y.numpy())))
    np.testing.assert_allclose(imgs, want, atol=2e-5, rtol=0)

    feats = fid.get_model_features(gen, port, num_gen=es * epb,
                                   generator=torch.Generator().manual_seed(3))
    jfeats = jx(jax_resize_single_channel(jax_fid.fid_postprocess(jnp.asarray(want))))
    assert np.abs(feats - jfeats).max() < 1e-5 * np.abs(jfeats).max()
