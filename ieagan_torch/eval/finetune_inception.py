"""Finetune InceptionV3 on the PXD sensor-classification task: re-mints the
FID backbone ``stats/inception_pxd.msgpack`` (twin of
``scripts/finetune_inception.py``; reference recipe:
notebooks/Inception_re-training.ipynb, timm ``inception_v3`` with a head of
the 40 sensor classes at ~0.99 accuracy).

    python -m ieagan_torch.eval.finetune_inception --dataroot <pxd-data> \\
        [--out stats/inception_pxd.msgpack] [--steps 2000] [--batch 64] \\
        [--lr 1e-4] [--seed 0] [--max-events 300] [--val-frac 0.1] \\
        [--init-weights <torch state dict>] [--cpu]

The classifier is ``eval/inception.py::InceptionV3Features`` and a head
``fc = Linear(2048, n_sensors)``. As in the JAX script, every batch norm's
scale, bias, mean and variance is a trained parameter (flax params there;
the frozen extractor holds them as buffers). The trunk starts from
``init_feature_weights(seed)`` (He-normal) or ``--init-weights``, the head
as flax's ``Dense`` (lecun-normal kernel, zero bias). Adam (optax's
defaults) under a cosine decay of ``--lr`` to 0 over ``--steps``; the loss
is the mean softmax cross-entropy.

The images are the sensors' raw pixels in [0, 1] (no lognorm): the space the
extractor sees at FID time. They stay resident on the device as uint8
(``--max-events`` per sensor bounds them); each step draws ``--batch``
indices of the training split with replacement, scales by 1/255 and resizes
to 299x299 on the device (``eval/resize.py``, 3 channels). Products run in
f32 with TF32 off. Validation accuracy is over whole batches of the
held-out split, the tail dropped. The features alone are written as a flax
msgpack with the JAX tree's names, which both packages' extractors load.
Runs on the GPU unless ``--cpu`` or ``IEAGAN_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ieagan_torch.eval.inception import FrozenBatchNorm, InceptionV3Features

FEATURES = 2048
SIZE = (299, 299)
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)  # optax.adam's defaults
_F32 = np.float32


def load_raw_images(dataroot: str, max_events: int | None):
    """-> (images uint8 (n_sensors * n_events, H, W), labels int32,
    n_sensors): raw pixel values, sensor by sensor, each sensor's first
    ``max_events`` files by name (copy of ``scripts/finetune_inception.py:33-48``)."""
    from PIL import Image
    subdirs = sorted(os.listdir(dataroot))
    filenames = sorted(os.listdir(os.path.join(dataroot, subdirs[0])))
    if max_events:
        filenames = filenames[:max_events]
    imgs, labels = [], []
    for s, sub in enumerate(subdirs):
        for fn in filenames:
            with Image.open(os.path.join(dataroot, sub, fn)) as im:
                imgs.append(np.asarray(im.convert("L"), np.uint8))
            labels.append(s)
    return np.stack(imgs), np.asarray(labels, np.int32), len(subdirs)


def split(n: int, val_frac: float, seed: int):
    """``(train_idx, val_idx)``: one permutation of ``default_rng(seed)``,
    its first ``int(n * val_frac)`` held out (``finetune_inception.py:88-92``)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_val = int(n * val_frac)
    return perm[n_val:], perm[:n_val]


def cosine_decay(lr: float, steps: int):
    """``optax.cosine_decay_schedule(lr, steps)`` (alpha 0) as a function
    of the schedule's count, in float32 as optax evaluates it."""
    def sched(count: int) -> float:
        t = _F32(min(count, steps))
        decay = _F32(0.5) * (_F32(1.0) + np.cos(_F32(math.pi) * t / _F32(steps)))
        return float(_F32(lr) * decay)
    return sched


def train_batch_norms(module: nn.Module) -> nn.Module:
    """Every ``FrozenBatchNorm`` of ``module`` with its scale, bias, mean
    and variance turned from buffers into parameters (the same names and
    values, so the state dict is unchanged)."""
    for bn in module.modules():
        if isinstance(bn, FrozenBatchNorm):
            for name in ("weight", "bias", "running_mean", "running_var"):
                bn.register_parameter(name, nn.Parameter(bn._buffers.pop(name)))
    return module


class InceptionClassifier(nn.Module):
    """``features`` (InceptionV3, batch norms trained) and ``fc``: NCHW
    images in [0, 1] -> logits (``finetune_inception.py:103-107``)."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.features = train_batch_norms(InceptionV3Features())
        self.fc = nn.Linear(FEATURES, n_classes)

    def forward(self, x):
        return self.fc(self.features(x))


def build_classifier(n_classes: int, seed: int = 0, init_weights: str | None = None,
                     device="cuda") -> InceptionClassifier:
    """The classifier on ``device``: the trunk from ``init_weights`` (a
    torchvision/timm state dict, its ``fc`` dropped) or He-normal
    (``init_feature_weights(seed)``); the head lecun-normal (a normal of std
    sqrt(1/2048) truncated at two of its stds, as flax's, drawn from
    ``seed``) with a zero bias."""
    from ieagan_torch.eval.inception import inception_state_from_torch, init_feature_weights
    model = InceptionClassifier(n_classes)
    if init_weights:
        sd = torch.load(init_weights, map_location="cpu", weights_only=False)
        trunk = inception_state_from_torch(sd if isinstance(sd, dict) else sd.state_dict())
    else:
        trunk = init_feature_weights(seed)
    model.features.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                                    for k, v in trunk.items()}, strict=True)
    # flax's lecun_normal: variance 1/fan_in of the truncated normal
    std = math.sqrt(1.0 / FEATURES) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(model.fc.weight, std=std, a=-2 * std, b=2 * std,
                              generator=torch.Generator().manual_seed(seed))
        model.fc.bias.zero_()
    return model.to(device)


def batch_from_idx(images: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor,
                   size=SIZE):
    """Rows ``idx`` of the resident uint8 images as (B, 3, H, W) in [0, 1]
    at ``size``, and their labels (``finetune_inception.py:126-128``)."""
    from ieagan_torch.eval.resize import resize_single_channel
    return resize_single_channel(images[idx].float() / 255.0, size=size), labels[idx]


def train_step(model, opt, images, labels, idx, lr, size=SIZE) -> torch.Tensor:
    """One Adam step on rows ``idx``; returns ``[loss, accuracy]`` of the
    batch before the update (``finetune_inception.py:130-145``)."""
    x, y = batch_from_idx(images, labels, idx, size)
    for p in model.parameters():
        p.grad = None
    logits = model(x)
    loss = F.cross_entropy(logits, y.long())
    loss.backward()
    opt.step(lr)
    with torch.no_grad():
        acc = (logits.argmax(-1) == y).float().mean()
    return torch.stack([loss.detach(), acc])


@torch.no_grad()
def validation_accuracy(model, images, labels, val_idx: np.ndarray, batch: int,
                        size=SIZE) -> tuple[float, int]:
    """Mean accuracy over the whole batches of ``val_idx``, the tail
    dropped, and the number of images it read (``:165-171``)."""
    accs = []
    for i in range(0, len(val_idx) - batch + 1, batch):
        idx = torch.as_tensor(val_idx[i:i + batch], device=images.device)
        x, y = batch_from_idx(images, labels, idx, size)
        accs.append(float((model(x).argmax(-1) == y).float().mean()))
    return (float(np.mean(accs)) if accs else float("nan")), len(accs) * batch


def write_features(model: InceptionClassifier, path: str):
    """The trunk as a flax msgpack with the JAX package's tree names."""
    from ieagan_torch.eval.inception import inception_state_to_flax
    from ieagan_torch.utils.flax_msgpack import msgpack_serialize
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fp:
        fp.write(msgpack_serialize(inception_state_to_flax(model.features.state_dict())))


def main(argv=None) -> dict:
    """Train, validate and write the backbone; returns the last metrics,
    the validation accuracy and ms per step (steps after the first)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--out", default="stats/inception_pxd.msgpack")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-events", type=int, default=300,
                    help="events per sensor to load (bounds the resident images)")
    ap.add_argument("--val-frac", type=float, default=0.1)
    ap.add_argument("--init-weights", default=None,
                    help="optional torch state dict to start from")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from ieagan_torch.eval.fid import f32_products
    from ieagan_torch.train.cli import tool_device
    from ieagan_torch.train.optim import OptaxAdam

    device = tool_device(args.cpu)
    imgs_u8, labels_np, n_classes = load_raw_images(args.dataroot, args.max_events)
    n = imgs_u8.shape[0]
    print(f"{n} images, {n_classes} sensors, {imgs_u8.nbytes / 1e9:.2f} GB raw", flush=True)
    train_idx, val_idx = split(n, args.val_frac, args.seed)

    t0 = time.time()
    images = torch.from_numpy(imgs_u8).to(device)
    labels = torch.from_numpy(labels_np).to(device)
    d_train_idx = torch.from_numpy(train_idx).to(device)
    print(f"dataset resident on {device} in {time.time() - t0:.1f}s", flush=True)

    model = build_classifier(n_classes, args.seed, args.init_weights, device)
    opt = OptaxAdam(model.parameters(), **ADAM)
    schedule = cosine_decay(args.lr, args.steps)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    synchronize = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    metrics, times = None, []
    t0 = time.time()
    with f32_products():
        for step in range(args.steps):
            synchronize()
            t = time.perf_counter()
            idx = d_train_idx[torch.randint(0, len(train_idx), (args.batch,), device=device,
                                            generator=generator)]
            metrics = train_step(model, opt, images, labels, idx, schedule)
            if step % 50 == 0:
                loss, acc = metrics.tolist()  # one fetch
                print(f"step {step}: loss {loss:.4f} acc {acc:.3f} ({time.time() - t0:.0f}s)",
                      flush=True)
            synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        # held-out accuracy (the reference's recipe reports ~0.99)
        val_acc, n_val = validation_accuracy(model, images, labels, val_idx, args.batch)
    print(f"validation accuracy: {val_acc:.4f} over {n_val} images", flush=True)

    write_features(model, args.out)
    print(f"saved feature-extractor params to {args.out}", flush=True)
    steady = times[1:] or times
    return {"loss_acc": None if metrics is None else metrics.tolist(), "val_acc": val_acc,
            "n_val": n_val, "step_ms": float(np.median(steady)) if steady else float("nan")}


if __name__ == "__main__":
    main()
