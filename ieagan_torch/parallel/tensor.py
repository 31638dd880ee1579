"""The column- and row-split layers of the mesh's model axis (twin of what
``ieagan_tpu/parallel/sharding.py:40-83`` asks of XLA under
``tensor_parallel``).

The JAX package splits a leaf over the ``"model"`` axis by its sharding and
lets GSPMD place the collectives. Here each split layer holds its rank's
shard of the weight as the ``nn.Parameter`` and computes with Megatron's
operators (``parallel/collectives.py``):

  * column (the output axis split): the replicated input enters through
    ``model_copy``, the layer computes its slice of the output (with its
    slice of the replicated bias, through ``model_scatter``), and the slices
    are gathered along the channels (``model_gather``), unless the consumer
    is its pair's row layer;
  * row (the input axis split, the second layer of a pair): the layer takes
    its slice of the input (``model_scatter``, unless its pair kept the
    activation split), computes a partial output, sums it over the axis
    (``model_reduce``) and adds the replicated bias once.

The pairs keep their activation split, one all-reduce per pair, as the JAX
rule intends: the RRM's MLP (``linear1`` -> ReLU -> ``linear2``), the RRM's
attention (``qkv_proj`` -> attention -> ``o_proj``: the packed qkv is
head-major, so a column split is a split by heads when the heads divide the
axis), and SA-GAN's ``g`` -> attention -> ``o``. When the heads do not
divide the axis, qkv is gathered, every rank computes every head, and
``o_proj`` takes its slice of their output.

Each split layer is the port's layer (``ops/spectral.py``) with its class
swapped in place for a subclass, as ``torch.nn.utils.parametrize`` does:
names, state-dict keys and ``isinstance`` checks stay, and the layer can be
swapped back to its plain class holding the full weight
(``parallel/sharding.py::gather_state``). SA-GAN's attention whose ``g``/``o``
pair is split is swapped so too (``pair_attention``): its ``theta`` and
``phi`` stay whole, and every rank attends with the whole q and k to its
channels of v, so their gradients are the sums of the ranks' partial ones.

A split SN layer's power iteration (``ops/spectral.py::power_iteration``)
runs over the axis without gathering W (``_SplitProducts``): each
contraction over the split axis sums its partial vector over the ranks, each
vector the iteration keeps is whole (a split one is gathered), and sigma is
the sum of the ranks' partial ``v W uᵀ``, whose gradient reaches each rank's
block through the sum of the ranks' partial gradients. ``u`` and ``sv`` stay
whole and replicated.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ieagan_torch.ops.attention import SelfAttention2d
from ieagan_torch.ops.rrm import EncoderBlock, MultiheadSelfAttention
from ieagan_torch.ops.spectral import (Conv2d, Embedding, Linear, SNConv2d, SNEmbedding,
                                       SNLinear)
from ieagan_torch.parallel.collectives import (model_copy, model_gather, model_reduce,
                                               model_scatter)


@dataclasses.dataclass(frozen=True)
class Split:
    """How a layer's weight is split: ``style`` "column" or "row", the
    weight's torch ``dim`` the model axis cuts, the ``mesh``, and whether
    the layer is one of a pair that keeps the activation between them split
    (``paired``: a column layer does not gather its output, a row layer
    takes its input already split)."""
    style: str
    dim: int
    mesh: object
    paired: bool = False


class _SplitLayer:
    """The forward of a split layer, mixed in before the port's layer."""

    @property
    def tp(self) -> Split:
        return self._tp

    @property
    def sn_products(self):
        return _SplitProducts(self._tp)

    def forward(self, x):
        tp = self._tp
        w = self.normalized_weight() if hasattr(self, "normalized_weight") else self.weight
        if isinstance(self, (Embedding, SNEmbedding)):
            out = F.embedding(x, w)
            return out if tp.paired else model_gather(out, -1, tp.mesh)
        conv = w.ndim == 4
        dim = 1 if conv else -1
        op = ((lambda t, b: F.conv2d(t, w.to(t.dtype), b, padding=self.padding)) if conv
              else (lambda t, b: F.linear(t, w.to(t.dtype), b)))
        if tp.style == "column":
            bias = None if self.bias is None else model_scatter(self.bias, 0, tp.mesh).to(x.dtype)
            out = op(model_copy(x, tp.mesh), bias)
            return out if tp.paired else model_gather(out, dim, tp.mesh)
        if not tp.paired:
            x = model_scatter(x, dim, tp.mesh)
        out = model_reduce(op(x, None), tp.mesh)
        if self.bias is None:
            return out
        bias = self.bias.to(out.dtype)
        return out + (bias[:, None, None] if conv else bias)


class _SplitProducts:
    """The power iteration's products with this rank's block of rows (the
    torch weight's dim 0) or columns (dim 1) of the (out, fan-in) matrix."""

    def __init__(self, split: Split):
        self.axis, self.mesh = split.dim, split.mesh

    def _block(self, n: int) -> slice:
        return slice(self.mesh.model_index * n, (self.mesh.model_index + 1) * n)

    def v(self, u, w):
        if self.axis == 0:
            return model_reduce(u[self._block(w.shape[0])] @ w, self.mesh)
        return model_gather(u @ w, 0, self.mesh)

    def u(self, v, w):
        if self.axis == 0:
            return model_gather(v @ w.T, 0, self.mesh)
        return model_reduce(v[self._block(w.shape[1])] @ w.T, self.mesh)

    def sigma(self, vs, w_mat, us):
        if self.axis == 0:
            us = us[:, self._block(w_mat.shape[0])]
        else:
            vs = vs[:, self._block(w_mat.shape[1])]
        partial = torch.einsum("sk,ok,so->s", vs, w_mat, us)
        return model_reduce(model_copy(partial, self.mesh), self.mesh)


class SplitLinear(_SplitLayer, Linear):
    pass


class SplitConv2d(_SplitLayer, Conv2d):
    pass


class SplitEmbedding(_SplitLayer, Embedding):
    pass


class SplitSNLinear(_SplitLayer, SNLinear):
    pass


class SplitSNConv2d(_SplitLayer, SNConv2d):
    pass


class SplitSNEmbedding(_SplitLayer, SNEmbedding):
    pass


class SplitSelfAttention2d(SelfAttention2d):
    """SA-GAN's attention with its ``g``/``o`` pair split."""

    def _attend(self, q, k, v):
        mesh = self.g.tp.mesh
        return super()._attend(model_copy(q, mesh), model_copy(k, mesh), v)


SPLIT_CLASSES = {Linear: SplitLinear, Conv2d: SplitConv2d, Embedding: SplitEmbedding,
                 SNLinear: SplitSNLinear, SNConv2d: SplitSNConv2d,
                 SNEmbedding: SplitSNEmbedding}
PLAIN_CLASSES = {v: k for k, v in SPLIT_CLASSES.items()}


def _pairs(model, n_model: int):
    """``(first, second)`` module names of every pair in ``model`` whose
    activation may stay split over ``n_model`` ranks."""
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, EncoderBlock):
            yield prefix + "linear1", prefix + "linear2"
        elif isinstance(m, MultiheadSelfAttention) and m.num_heads % n_model == 0:
            yield prefix + "qkv_proj", prefix + "o_proj"
        elif isinstance(m, SelfAttention2d):
            yield prefix + "g", prefix + "o"


def layer_splits(model, rule: dict, mesh) -> dict:
    """``{module name: Split}`` for ``rule`` (``{parameter name: (style,
    torch dim)}``, ``parallel/sharding.py::split_rule``). Every split
    parameter must be the weight of one of the port's six layers (column:
    its dim 0, or an embedding's dim 1; row: its dim 1), else this raises:
    nothing the rule splits stays whole."""
    modules = dict(model.named_modules())
    styles = {}
    for pname, (style, dim) in rule.items():
        mname, _, leaf = pname.rpartition(".")
        module = modules.get(mname)
        if leaf != "weight" or type(module) not in SPLIT_CLASSES:
            raise ValueError(f"{pname}: the tensor-parallel rule splits it, and no split "
                             f"layer takes a {type(module).__name__}'s {leaf}")
        embedding = isinstance(module, (Embedding, SNEmbedding))
        want = {("column", False): 0, ("column", True): 1, ("row", False): 1}.get(
            (style, embedding))
        if dim != want:
            raise ValueError(f"{pname}: a {style} split of dim {dim} has no split layer")
        styles[mname] = (style, dim)
    paired = set()
    for first, second in _pairs(model, mesh.n_model):
        if styles.get(first, ("",))[0] == "column" and styles.get(second, ("",))[0] == "row":
            paired |= {first, second}
    return {name: Split(style, dim, mesh, name in paired)
            for name, (style, dim) in styles.items()}


@torch.no_grad()
def shard(tensor: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This model rank's slice of ``tensor`` along ``dim``, contiguous."""
    size = tensor.shape[dim] // mesh.n_model
    return tensor.narrow(dim, mesh.model_index * size, size).clone(
        memory_format=torch.contiguous_format)


def split_layer(module, split: Split) -> None:
    """Make ``module`` (one of the six layers, holding its full weight) a
    split layer holding its rank's shard, in place."""
    module.__class__ = SPLIT_CLASSES[PLAIN_CLASSES.get(type(module), type(module))]
    module._tp = split
    module.weight.data = shard(module.weight.data, split.dim, split.mesh)


def unsplit_layer(module, full_weight: torch.Tensor) -> None:
    """Make the split layer ``module`` its plain self again, holding
    ``full_weight``; it keeps its ``Split`` for ``split_layer``."""
    module.weight.data = full_weight
    module.__class__ = PLAIN_CLASSES[type(module)]


def pair_attention(model) -> None:
    """Make each SA-GAN attention of ``model`` a ``SplitSelfAttention2d``
    where its ``g``/``o`` pair is split, and plain where it is not, in
    place."""
    for m in model.modules():
        if isinstance(m, SelfAttention2d):
            paired = isinstance(m.g, _SplitLayer) and m.g.tp.paired
            m.__class__ = SplitSelfAttention2d if paired else SelfAttention2d


def split_layers(model) -> list:
    """``(name, module)`` of every layer of ``model`` that holds a shard."""
    return [(n, m) for n, m in model.named_modules() if isinstance(m, _SplitLayer)]


def split_parameters(model) -> frozenset:
    """The ``id``s of the parameters of ``model`` that hold a shard."""
    return frozenset(id(m.weight) for _, m in split_layers(model))
