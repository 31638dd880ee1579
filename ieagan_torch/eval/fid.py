"""clean-FID engine: model features, custom stats, Fréchet and kernel
distances (twin of ``ieagan_tpu/eval/fid.py``; reference: mycleanfid/fid.py).

  * per-image postprocess (fid.py:681-687): threshold -0.25 to -1, [0, 1],
    (256^x - 1)/255 clamped to [0, 1], rows 3:-3;
  * labels a fresh permutation of the event's classes, z by the truncation
    trick when ``trunc`` is set (fid.py:637-643, 673);
  * resize: PIL's single-channel float resize to 299x299 on the host, or its
    port ``F.interpolate(antialias=True)`` on the device (``resize.py``);
  * features: InceptionV3, 2048-d pooled (``inception.py``), in f32 with TF32
    off for the call;
  * FID: scipy ``sqrtm`` Fréchet distance in f64 on the host (fid.py:431-468);
    KID: the cubic-kernel MMD over subsets (fid.py:476-487), drawn from numpy's
    ``default_rng`` so that a seed gives the JAX package's subsets;
  * reference statistics ``<name>_<mode>_custom_na.npz`` with mu/sigma
    (fid.py:392-407) under ``$IEAGAN_STATS_DIR`` (default: the repo's
    ``stats/``), minted by ``make_custom_stats`` (fid.py:832-867).

Random numbers come from the caller's ``torch.Generator``: the same seed
does not give the JAX package's draws.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import pathlib

import numpy as np
import torch

from ieagan_torch.eval.inception import (build_inception, inception_state_from_flax,
                                         inception_state_from_torch, init_feature_weights)
from ieagan_torch.eval.resize import pil_resize_batch, resize_single_channel
from ieagan_torch.utils.sampling import eval_mode, trunc_trick

DEFAULT_STATS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "stats")


def stats_dir() -> str:
    """Where reference statistics live: ``$IEAGAN_STATS_DIR``, else the
    repo's ``stats/``."""
    return os.environ.get("IEAGAN_STATS_DIR", DEFAULT_STATS_DIR)


@contextlib.contextmanager
def f32_products():
    """cuDNN convolutions and matmuls in f32 without TF32 for the block, the
    previous settings restored after it. PyTorch lets cuDNN use TF32 by
    default; the moments' pin at 2048 dims assumes f32-accurate products."""
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, matmul


# ---------------------------------------------------------------- features

# The loaded backbone keyed by (path, mtime, device): re-minting the file
# invalidates the entry; at most one backbone stays resident.
_LOADED: dict = {}


def load_inception_state(path: str) -> dict:
    """A backbone file as a torch-layout state dict: flax params
    (``.msgpack``, read by the port's reader) or a torch state dict."""
    if path.endswith(".msgpack"):
        from ieagan_torch.utils.flax_msgpack import read_checkpoint
        return inception_state_from_flax(read_checkpoint(path))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return inception_state_from_torch(obj if isinstance(obj, dict) else obj.state_dict())


class FeatureExtractor:
    """InceptionV3 features on ``device`` from a weights file, or from the
    numpy-seeded fallback weights when there is none."""

    def __init__(self, weights_path: str | None = None, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        if weights_path and not os.path.exists(weights_path):
            # an explicitly requested backbone that is absent must not degrade
            # to the fallback: every FID of the run would be noise
            raise FileNotFoundError(f"FID backbone weights not found: {weights_path}")
        if not weights_path:
            weights_path = os.environ.get("IEAGAN_INCEPTION_WEIGHTS")
            if weights_path and not os.path.exists(weights_path):
                weights_path = None
        if weights_path:
            key = (os.path.abspath(weights_path), os.path.getmtime(weights_path), str(self.device))
            if key not in _LOADED:
                _LOADED.clear()
                _LOADED[key] = build_inception(load_inception_state(weights_path), self.device)
            self.model = _LOADED[key]
            self.source = weights_path
        else:
            self.model = build_inception(init_feature_weights(seed), self.device)
            self.source = (f"random-init(seed={seed}), numpy He-normal: not the JAX "
                           "package's fallback weights")

    @torch.inference_mode()
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, 299, 299) in [0, 1] -> (B, 2048) f32 on the device."""
        with f32_products():
            return self.model(images.to(self.device, torch.float32))

    def __call__(self, images) -> np.ndarray:
        """NCHW images (tensor or numpy) -> (B, 2048) float32 numpy."""
        return self.features(torch.as_tensor(images)).cpu().numpy()


# ------------------------------------------------------------- postprocess

def fid_postprocess(imgs: torch.Tensor) -> torch.Tensor:
    """Generator output (B, H, W, 1) in [-1, 1] -> (B, H-6, W) in [0, 1]
    (reference: fid.py:681-687; threshold -0.25 here, -0.26 in generate)."""
    x = torch.where(imgs > -0.25, imgs, torch.full_like(imgs, -1.0))
    x = x * 0.5 + 0.5
    x = torch.clamp((torch.pow(256.0, x) - 1.0) / 255.0, 0.0, 1.0)
    return x[:, 3:-3, :, 0]


# ------------------------------------------------------------- distances

def _sqrtm(a: np.ndarray) -> np.ndarray:
    """scipy's matrix square root, without its error estimate: scipy 1.18
    dropped ``disp`` and returns the root alone."""
    from scipy import linalg
    if "disp" in inspect.signature(linalg.sqrtm).parameters:
        return linalg.sqrtm(a, disp=False)[0]
    return linalg.sqrtm(a)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance (reference: fid.py:431-468)."""
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def _frechet_device(mu1, sigma1, mu2, sigma2) -> torch.Tensor:
    """Fréchet distance on the tensors' device in f32: for PSD covariances
    tr sqrtm(S1 S2) = sum sqrt eig(S1^1/2 S2 S1^1/2), S1^1/2 from a
    symmetric eigendecomposition.

    WARNING: at 2048 dims the eigh's absolute eigenvalue error scales with
    ||S1||·||S2||, so tr_sqrt can be off by O(1e3), which swamps (and can
    negate) small FIDs. Fine for small feature dims (test-pinned at d=96);
    ``compute_fid`` therefore finishes on the host in f64."""
    diff = mu1 - mu2
    w1, v1 = torch.linalg.eigh(sigma1)
    root1 = (v1 * torch.sqrt(torch.clamp(w1, min=0.0))) @ v1.T
    m = root1 @ sigma2 @ root1
    wm = torch.linalg.eigvalsh((m + m.T) * 0.5)
    tr_sqrt = torch.sqrt(torch.clamp(wm, min=0.0)).sum()
    return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2.0 * tr_sqrt


def kernel_distance(feats1, feats2, num_subsets: int = 100,
                    max_subset_size: int = 1000, seed: int | None = None) -> float:
    """KID with the cubic polynomial kernel (reference: fid.py:476-487)."""
    rng = np.random.default_rng(seed)
    n = feats1.shape[1]
    m = min(min(feats1.shape[0], feats2.shape[0]), max_subset_size)
    t = 0.0
    for _ in range(num_subsets):
        x = feats2[rng.choice(feats2.shape[0], m, replace=False)]
        y = feats1[rng.choice(feats1.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.diag(a).sum()) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def kid_self_floor(ref_feats, seed: int | None = 0) -> float:
    """Real-vs-real KID of a half/half split of the reference features: the
    floor a generator's KID is read against."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(ref_feats.shape[0])
    half = len(idx) // 2
    return kernel_distance(ref_feats[idx[:half]], ref_feats[idx[half:]], seed=seed)


# ------------------------------------------------------------ feature runs

def _mode_options(mode: str):
    """"clean": bilinear resize of [0, 1] inputs (fid.py); "clean_255":
    bicubic resize of [0, 255] inputs (fid-Copy_255.py:51,152)."""
    if mode == "clean_255":
        return "bicubic", 255.0
    return "bilinear", 1.0


def _moment_update(acc_s: torch.Tensor, acc_o: torch.Tensor, f: torch.Tensor,
                   pilot: torch.Tensor):
    """Add the sum and XᵀX of pilot-centred features to the accumulators, in
    place, in f32 (the caller turns TF32 off). Centring by a first-batch
    pilot mean keeps the accumulated means near zero, so the one-pass sigma
    (o - n mu muᵀ) loses almost nothing to cancellation at 2048 dims."""
    fc = (f - pilot).float()
    acc_s.add_(fc.sum(0))
    acc_o.addmm_(fc.T, fc)


def get_model_features(gen_fn, extractor: FeatureExtractor, *, num_gen: int,
                       generator: torch.Generator | None = None, resize_on_device: bool = True,
                       mode: str = "clean", return_moments: bool = False):
    """Features of ``num_gen`` images from ``gen_fn(generator)``, which
    returns (N, H, W, 1) images in [-1, 1] (labels permuted inside).

    Only the images still needed are resized and featurised. With
    ``return_moments`` the features stay on the device: their pilot-centred
    sum and XᵀX accumulate there in f32, and (mu, sigma, n) are assembled in
    f64 on the host (within f64 ``np.cov``'s rounding, test-pinned at 2048
    dims). Otherwise returns the (num_gen, 2048) features as numpy. The
    batch is whatever ``gen_fn`` returns."""
    interp, scale = _mode_options(mode)
    device = extractor.device
    feats, total, pilot = [], 0, None
    with torch.inference_mode(), f32_products():
        while total < num_gen:
            imgs = gen_fn(generator)[:num_gen - total]
            imgs01 = fid_postprocess(imgs.float()) * scale
            if resize_on_device:
                batch299 = resize_single_channel(imgs01.to(device), interp=interp)
            else:
                batch299 = torch.from_numpy(pil_resize_batch(imgs01.cpu().numpy(), interp=interp))
            f = extractor.features(batch299)
            total += int(f.shape[0])
            if return_moments:
                if pilot is None:
                    pilot = f.mean(0)
                    acc_s = torch.zeros_like(pilot)
                    acc_o = pilot.new_zeros((f.shape[1], f.shape[1]))
                _moment_update(acc_s, acc_o, f, pilot)
            else:
                feats.append(f.cpu().numpy())
    if return_moments:
        s = acc_s.cpu().numpy().astype(np.float64)
        o = acc_o.cpu().numpy().astype(np.float64)
        p = pilot.cpu().numpy().astype(np.float64)
        n = float(total)
        mu = p + s / n
        sigma = (o - n * np.outer(s / n, s / n)) / (n - 1.0)
        return mu, sigma, total
    return np.concatenate(feats)


def _image_files(fdir, num=None) -> list:
    files = sorted(p for p in pathlib.Path(fdir).rglob("*")
                   if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".bmp", ".tiff"))
    return files if num is None else files[:num]


def get_folder_features(fdir, extractor: FeatureExtractor, num=None, batch_size: int = 64,
                        resize_on_device: bool = False, mode: str = "clean") -> np.ndarray:
    """Features of every image under ``fdir`` (reference: fid.py:843-860),
    loaded as single-channel [0, 1] ("clean") or [0, 255] ("clean_255").
    ``resize_on_device`` uploads uint8 and resizes on the extractor's device;
    else PIL resizes on the host."""
    from PIL import Image
    interp, scale = _mode_options(mode)
    files = _image_files(fdir, num)
    feats = []
    for i in range(0, len(files), batch_size):
        chunk = files[i:i + batch_size]
        if resize_on_device:
            raw = np.stack([np.asarray(Image.open(f).convert("L"), np.uint8) for f in chunk])
            imgs = torch.from_numpy(raw).to(extractor.device).float() * (scale / 255.0)
            batch299 = resize_single_channel(imgs, interp=interp)
        else:
            imgs = np.stack([np.asarray(Image.open(f).convert("L"), np.float32) * (scale / 255.0)
                             for f in chunk])
            batch299 = torch.from_numpy(pil_resize_batch(imgs, interp=interp))
        feats.append(extractor(batch299))
    return np.concatenate(feats)


# --------------------------------------------------------------- stats API

def _stats_path(name: str, mode: str = "clean", split: str = "custom", res: str = "na") -> str:
    return os.path.join(stats_dir(), f"{name}_{mode}_{split}_{res}.npz".lower())


def get_reference_statistics(name: str, mode: str = "clean", split: str = "custom",
                             res: str = "na"):
    path = _stats_path(name, mode, split, res)
    if not os.path.exists(path):
        raise FileNotFoundError(f"reference statistics {path} not found; mint them with "
                                "ieagan_torch.eval.fid.make_custom_stats")
    stats = np.load(path)
    return stats["mu"], stats["sigma"]


def _mint(path: str, fdir, num, mode, batch_size, extractor, overwrite, resize_on_device):
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"statistics file {path} already exists")
    feats = get_folder_features(fdir, extractor, num=num, batch_size=batch_size, mode=mode,
                                resize_on_device=resize_on_device)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return feats


def make_custom_stats(name: str, fdir: str, num=None, mode: str = "clean", batch_size: int = 64,
                      extractor: FeatureExtractor | None = None, overwrite: bool = False,
                      resize_on_device: bool = False) -> str:
    """Mint mu/sigma reference stats from a folder of real images
    (reference: fid.py:832-867)."""
    path = _stats_path(name, mode)
    feats = _mint(path, fdir, num, mode, batch_size, extractor or FeatureExtractor(), overwrite,
                  resize_on_device)
    np.savez_compressed(path, mu=np.mean(feats, axis=0), sigma=np.cov(feats, rowvar=False))
    return path


def make_custom_kid_stats(name: str, fdir: str, num=None, mode: str = "clean",
                          batch_size: int = 64, extractor: FeatureExtractor | None = None,
                          overwrite: bool = False, resize_on_device: bool = False) -> str:
    """Mint raw-feature KID stats ``<name>_<mode>_custom_na_kid.npz``
    (reference: fid.py:402-407)."""
    path = _stats_path(name, mode).replace(".npz", "_kid.npz")
    feats = _mint(path, fdir, num, mode, batch_size, extractor or FeatureExtractor(), overwrite,
                  resize_on_device)
    np.savez_compressed(path, feats=feats)
    return path


# ----------------------------------------------------------- top-level API

def compute_kid(gen_fn=None, fdir1=None, fdir2=None, *, dataset_name: str = "pxd_sim_test_com",
                num_gen: int = 16000, batch_size: int = 40,
                generator: torch.Generator | None = None,
                extractor: FeatureExtractor | None = None, resize_on_device: bool = True,
                seed: int | None = 0, mode: str = "clean") -> float:
    """KID of a generator against stored raw features, or between two
    folders (fid.py:476-487, wired in as a first-class metric)."""
    if fdir1 is not None and fdir2 is not None:
        extractor = extractor or FeatureExtractor()
        f1 = get_folder_features(fdir1, extractor, batch_size=batch_size, mode=mode)
        f2 = get_folder_features(fdir2, extractor, batch_size=batch_size, mode=mode)
        return kernel_distance(f1, f2, seed=seed)
    path = _stats_path(dataset_name, mode).replace(".npz", "_kid.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"KID reference features {path} not found; mint them with "
                                "make_custom_kid_stats")
    ref_feats = np.load(path)["feats"]
    feats = get_model_features(gen_fn, extractor or FeatureExtractor(), num_gen=num_gen,
                               generator=generator, resize_on_device=resize_on_device, mode=mode)
    return kernel_distance(feats, ref_feats, seed=seed)


def compute_fid(gen_fn=None, fdir1=None, fdir2=None, *, dataset_name: str = "pxd_sim_test_com",
                num_gen: int = 16000, batch_size: int = 40,
                generator: torch.Generator | None = None,
                extractor: FeatureExtractor | None = None, resize_on_device: bool = True,
                return_features: bool = False, moments_on_device: bool = False,
                mode: str = "clean"):
    """FID of a generator against dataset stats, or between two folders
    (reference: fid.py:870-942; mode "clean_255" is fid-Copy_255.py's
    bicubic [0, 255] variant). With ``moments_on_device`` the features'
    moments accumulate on the device and the Fréchet distance finishes on
    the host in f64 (an f32 eigh at 2048 dims can be off by O(1e3))."""
    if fdir1 is not None and fdir2 is not None:
        extractor = extractor or FeatureExtractor()
        f1 = get_folder_features(fdir1, extractor, batch_size=batch_size, mode=mode)
        f2 = get_folder_features(fdir2, extractor, batch_size=batch_size, mode=mode)
        fid = frechet_distance(np.mean(f1, 0), np.cov(f1, rowvar=False),
                               np.mean(f2, 0), np.cov(f2, rowvar=False))
        return (fid, f1, f2) if return_features else fid
    if gen_fn is None:
        raise ValueError("need gen_fn or two folders")
    ref_mu, ref_sigma = get_reference_statistics(dataset_name, mode=mode)
    extractor = extractor or FeatureExtractor()
    if moments_on_device and not return_features:
        mu, sigma, _ = get_model_features(gen_fn, extractor, num_gen=num_gen,
                                          generator=generator, resize_on_device=resize_on_device,
                                          mode=mode, return_moments=True)
        return float(frechet_distance(mu, sigma, ref_mu, ref_sigma))
    feats = get_model_features(gen_fn, extractor, num_gen=num_gen, generator=generator,
                               resize_on_device=resize_on_device, mode=mode)
    fid = frechet_distance(np.mean(feats, 0), np.cov(feats, rowvar=False), ref_mu, ref_sigma)
    return (fid, feats) if return_features else fid


def draw_fid_latents(generator: torch.Generator | None, n_classes: int, events: int,
                     dim_z: int, rdof_dim: int, trunc: float | None = None, device="cuda"):
    """One FID batch's draws, in this order: z (truncation trick at
    ``trunc``, else normal), a fresh permutation of the classes per event,
    and G's rdof."""
    n = n_classes * events
    z = (trunc_trick(generator, (n, dim_z), bound=trunc, device=device) if trunc is not None
         else torch.randn((n, dim_z), generator=generator, device=device))
    y = torch.cat([torch.randperm(n_classes, generator=generator, device=device)
                   for _ in range(events)])
    rdof = torch.randn((n, rdof_dim), generator=generator, device=device)
    return z, y, rdof


def make_generator_fn(G, config: dict, trunc: float | None = None, chunks: int = 1,
                      dtype: torch.dtype = torch.float32):
    """``gen_fn(generator)`` -> ``chunks`` event batches of G in eval mode,
    (chunks * n_classes * events_per_batch, H, W, 1) f32 on G's device,
    computed in ``dtype``, with permuted labels (reference: fid.py:670-680).
    The chunks are written into one output."""
    es = int(config["n_classes"])
    epb = int(config.get("events_per_batch", 1))
    dim_z, rdof_dim = int(config["dim_z"]), int(config["rdof_dim"])
    device = next(G.parameters()).device

    @torch.inference_mode()
    def gen_fn(generator: torch.Generator | None):
        out = None
        with eval_mode(G):
            for i in range(chunks):
                z, y, rdof = draw_fid_latents(generator, es, epb, dim_z, rdof_dim, trunc, device)
                imgs = G(z.to(dtype), y, rdof).float()
                if out is None:
                    out = torch.empty((chunks * imgs.shape[0], *imgs.shape[1:]),
                                      dtype=imgs.dtype, device=device)
                out[i * imgs.shape[0]:(i + 1) * imgs.shape[0]] = imgs
        return out

    return gen_fn


_EXTRACTORS: dict = {}


def default_extractor(config: dict | None = None, device="cuda") -> FeatureExtractor:
    """The metric-defining extractor: ``config["fid_backbone"]``, or ("auto")
    ``stats/inception_pxd.msgpack`` when it exists (the re-minted analog of
    the reference's inception_V3_best.pt), else the seeded fallback. Cached
    per path and device."""
    backbone = (config or {}).get("fid_backbone", "auto")
    if backbone == "auto":
        cand = os.path.join(stats_dir(), "inception_pxd.msgpack")
        backbone = cand if os.path.exists(cand) else None
    key = (backbone, str(torch.device(device)))
    if key not in _EXTRACTORS:
        _EXTRACTORS[key] = FeatureExtractor(weights_path=backbone, seed=0, device=device)
    return _EXTRACTORS[key]


def compute_fid_with(G, config: dict, dtype: torch.dtype = torch.float32,
                     return_features: bool = False):
    """FID of generator ``G`` (in ``dtype``) against the configured dataset
    stats, as the driver's test computes it: trunc-trick z at ``fid_trunc``
    (<= 0 opts out), ``fid_gen_chunks`` batches per call,
    ``num_incep_images`` images, seeded from the config's seed, moments on
    the device unless ``fid_moments_on_device`` is false or the features
    are asked for."""
    device = next(G.parameters()).device
    trunc = float(config.get("fid_trunc", 1.0))
    gen = make_generator_fn(G, config, trunc=trunc if trunc > 0 else None,
                            chunks=int(config.get("fid_gen_chunks", 8)), dtype=dtype)
    return compute_fid(
        gen, dataset_name=config.get("fid_dataset_name", "pxd_sim_test_com"),
        num_gen=int(config.get("num_incep_images", 16000)),
        generator=torch.Generator(device=device).manual_seed(int(config.get("seed", 0))),
        extractor=default_extractor(config, device),
        return_features=return_features,
        moments_on_device=bool(config.get("fid_moments_on_device", True)),
        mode=config.get("fid_mode", "clean"))


def compute_fid_from_state(state, config: dict) -> float:
    """Driver hook (reference: train_fns.py:209-233): FID of the run's
    generator (G_ema when the run keeps and uses it) in the state's compute
    type."""
    use_ema = bool(config.get("ema")) and bool(config.get("use_ema"))
    return compute_fid_with(state.G_ema if use_ema else state.G, config, state.compute_dtype)
