"""InceptionV3 feature extractor for clean-FID (twin of
``ieagan_tpu/eval/inception.py``).

The graph of torchvision/timm ``inception_v3`` up to the pooled 2048-d
features, with their module names (``Conv2d_1a_3x3``, ``Mixed_5b.branch1x1``,
...), so a torch state dict of that model loads as is. The reference's
backbone is that model finetuned on the 40 PXD sensor classes (reference:
mycleanfid/fid.py:33-64); the repo keeps its re-minted weights as flax
params in ``stats/inception_pxd.msgpack``, which ``inception_state_from_flax``
maps onto this module's ``state_dict()``.

Input: NCHW (B, 3, 299, 299) floats in [0, 1], no normalisation inside
(reference: fid.py:60-62); output (B, 2048) f32. Without weights,
``init_feature_weights(seed)`` gives numpy-seeded He-normal weights with
batch norm at identity: random-projection features, like the JAX package's
fallback, but not its numbers (that one draws from a JAX key), so the two
packages' fallback FIDs are not comparable.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3
_BN_FIELDS = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
              "bn_var": "running_var"}


class FrozenBatchNorm(nn.Module):
    """Inference batch norm, eps 1e-3, folded into one scale and shift as
    the JAX package folds it (``inception.py:55-60``)."""

    def __init__(self, channels: int):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            self.register_buffer(name, torch.full((channels,), fill))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class BasicConv2d(nn.Module):
    """conv (no bias) + frozen batch norm + relu."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def avg_pool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def max_pool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b1, b5, b3, self.branch_pool(avg_pool3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, max_pool3s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(avg_pool3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, max_pool3s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(avg_pool3(x))], dim=1)


class InceptionV3Features(nn.Module):
    """``forward_features`` + global average pool: (B, 3, 299, 299) in [0, 1]
    -> (B, 2048) f32. Built with torch's default conv init and identity
    batch norm: load a state dict (``build_inception``)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x.float())))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(max_pool3s2(x)))
        x = max_pool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)).float()


def init_feature_weights(seed: int = 0) -> dict:
    """The no-weights fallback as a torch-layout state dict of numpy arrays:
    He-normal conv weights (std sqrt(2 / fan_in), numpy ``default_rng(seed)``,
    drawn in ``state_dict()`` order) and batch norm at identity. He init
    keeps the activations' variance through the 17-layer relu stack, so the
    pooled features stay informative (``ieagan_tpu/eval/inception.py:44-48``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, value in InceptionV3Features().state_dict().items():
        if key.endswith("conv.weight"):
            fan_in = int(np.prod(value.shape[1:]))
            out[key] = (rng.standard_normal(tuple(value.shape)) * np.sqrt(2.0 / fan_in)
                        ).astype(np.float32)
        else:
            out[key] = value.numpy().copy()
    return out


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def inception_state_from_flax(params: Mapping) -> dict:
    """A flax params tree of the JAX package's ``InceptionV3Features`` (as
    ``stats/inception_pxd.msgpack`` holds it) as this module's
    ``state_dict()``: conv kernels HWIO -> OIHW, ``bn_scale/bn_bias/bn_mean/
    bn_var`` -> the batch norm's buffers. Raises on a key of the module that
    the tree lacks, or a leaf of the tree that fits no key."""
    want = InceptionV3Features().state_dict()
    out = {}
    for path, leaf in _flatten(params):
        leaf = np.asarray(leaf, np.float32)
        if path[-2:] == ("conv", "kernel"):
            key, leaf = ".".join(path[:-1]) + ".weight", leaf.transpose(3, 2, 0, 1)
        elif path[-1] in _BN_FIELDS:
            key = ".".join(path[:-1]) + ".bn." + _BN_FIELDS[path[-1]]
        else:
            raise KeyError(f"Inception params: leaf {'/'.join(path)} fits no module key")
        if key not in want:
            raise KeyError(f"Inception params: leaf {'/'.join(path)} -> {key} is not a module key")
        if tuple(want[key].shape) != leaf.shape:
            raise ValueError(f"Inception params: {key} has shape {leaf.shape}, "
                             f"the module {tuple(want[key].shape)}")
        out[key] = leaf
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"Inception params lack {len(missing)} module keys, e.g. {missing[:3]}")
    return out


def inception_state_to_flax(state: Mapping) -> dict:
    """The inverse of ``inception_state_from_flax``: this module's
    ``state_dict()`` (tensors or numpy arrays) as the JAX package's flax
    params tree of ``InceptionV3Features``, float32 numpy leaves: conv
    weights OIHW -> HWIO ``conv/kernel``, the batch norm's four tensors ->
    ``bn_scale/bn_bias/bn_mean/bn_var``. Raises unless ``state`` has exactly
    the module's keys."""
    want = InceptionV3Features().state_dict()
    if set(state) != set(want):
        odd = sorted(set(state) ^ set(want))
        raise KeyError(f"Inception state: {len(odd)} keys differ from the module's, "
                       f"e.g. {odd[:3]}")
    flax_names = {v: k for k, v in _BN_FIELDS.items()}
    tree: dict = {}
    for key, value in state.items():
        leaf = np.asarray(value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
                          else value, np.float32)
        parts = key.split(".")
        if parts[-2:] == ["conv", "weight"]:
            path, leaf = parts[:-1] + ["kernel"], np.ascontiguousarray(leaf.transpose(2, 3, 1, 0))
        else:
            path = parts[:-2] + [flax_names[parts[-1]]]
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return tree


def inception_state_from_torch(state: Mapping) -> dict:
    """A torchvision/timm ``inception_v3`` state dict restricted to this
    module's keys: the classifier (``fc``), the auxiliary head
    (``AuxLogits``) and ``num_batches_tracked`` are dropped. Raises on a
    module key the dict lacks."""
    want = InceptionV3Features().state_dict()
    out = {k: np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v,
                         np.float32)
           for k, v in state.items() if k in want}
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"Inception state dict lacks {len(missing)} module keys, e.g. {missing[:3]}")
    return out


def build_inception(state: Mapping, device="cuda") -> InceptionV3Features:
    """``InceptionV3Features`` on ``device`` in eval mode with ``state`` (a
    torch-layout state dict of numpy arrays or tensors) loaded."""
    with torch.device(device):
        model = InceptionV3Features()
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in state.items()},
                          strict=True)
    return model.eval().requires_grad_(False)
