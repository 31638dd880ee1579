"""Generator-only inference: the basf2 deployment path of the port (twin of
``ieagan_tpu/deploy/inference.py``; reference: ieagan.py:24-152 frozen
CONFIG, 1334-1340 Model, 1343-1366 generate).

A frozen flagship config and the exact postprocess contract: 40 latents ->
(40, 250, 768) ADU images with the -0.26 amplitude threshold. Beside it,
``sample_batched`` is a class-conditional image sampler (a configuration
without G's RRM, such as BigGAN-deep 256): labels drawn uniformly over the
classes, [-1, 1] images with no postprocess. Everything runs
on ``model.device`` (CUDA unless the caller asks for the CPU) in the model's
dtype (fp32 by default, as the JAX deploy path). Random numbers come from an
explicit ``torch.Generator`` on that device; the same seed does not give the
JAX package's numbers, so parity tests hand both sides the same z and rdof.
"""

from __future__ import annotations

import numpy as np
import torch

from ieagan_torch.core.config import DEFAULT_CONFIG
from ieagan_torch.core.spans import span
from ieagan_torch.models.convert import (generator_state_from_flax,
                                         generator_state_from_torch,
                                         generator_state_to_torch)
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.image_norm import generate_postprocess
from ieagan_torch.utils.flax_msgpack import read_checkpoint, resolve_generator_checkpoint

# Frozen deployment configuration (reference: ieagan.py:24-152): the training
# config with the inference-only fields of the deployment copy.
FROZEN_CONFIG = dict(DEFAULT_CONFIG, seed=415, D_attn="0", model="BigGAN_deep")


class Model:
    """Generator + weights on one device, ready to generate events.

    ``Model(config)`` builds a randomly initialized generator from ``seed``;
    ``Model.restore(path)`` loads a checkpoint of the JAX package and
    ``Model.from_torch(path)`` a reference-layout PyTorch ``.pth``;
    ``export_torch(path)`` writes one. Parameters stay f32; ``dtype`` is the
    compute type of the latents and activations.
    """

    def __init__(self, config: dict | None = None, device="cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 _random_init: bool = True):
        self.config = dict(FROZEN_CONFIG)
        if config:
            self.config.update(config)
        self.device = torch.device(device)
        self.dtype = dtype
        self.event_size = int(self.config["n_classes"])
        with torch.device(self.device):
            self.G = Generator.from_config(self.config)
        self.G.eval().requires_grad_(False)
        if _random_init:
            self.G.reset_parameters(
                torch.Generator(device=self.device).manual_seed(seed))

    @classmethod
    def restore(cls, weights_path: str, config: dict | None = None,
                use_ema: bool = True, device="cuda",
                dtype: torch.dtype = torch.float32, tag: str | None = None) -> "Model":
        """Load a Model from a JAX-package checkpoint: a weights dir (G_ema or
        G, newest copy tag or an explicit ``tag`` like "best0") or a single
        ``G*.msgpack`` file. Every checkpoint key must fit the Generator."""
        model = cls(config=config, device=device, dtype=dtype, _random_init=False)
        path = resolve_generator_checkpoint(weights_path, tag=tag, use_ema=use_ema)
        state = generator_state_from_flax(read_checkpoint(path), model.G.state_dict())
        model.G.load_state_dict({k: torch.tensor(v) for k, v in state.items()},
                                strict=True)
        return model

    @classmethod
    def from_torch(cls, state_dict_path: str, config: dict | None = None, device="cuda",
                   dtype: torch.dtype = torch.float32) -> "Model":
        """Load a Model from a reference-layout PyTorch Generator state dict
        (``.pth``; reference: model.py:139-487) through
        ``models/convert.py::generator_state_from_torch``; ``config``
        overrides ``FROZEN_CONFIG`` as in ``restore``. The file is read with
        ``weights_only=True``: a pickled module is refused (the JAX package
        unpickles it, which needs the reference code on the path)."""
        import pickle
        model = cls(config=config, device=device, dtype=dtype, _random_init=False)
        try:
            sd = torch.load(state_dict_path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as err:
            raise ValueError(f"{state_dict_path} is not a plain state dict of tensors "
                             "(a pickled module?); save model.state_dict() instead") from err
        if not isinstance(sd, dict):
            raise ValueError(f"{state_dict_path} holds a {type(sd).__name__}, not a state dict")
        state = generator_state_from_torch(sd, int(model.config["G_depth"]),
                                           template=model.G.state_dict())
        model.G.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
        return model

    def export_torch(self, out_path: str) -> str:
        """Write the generator as a reference-layout PyTorch state dict
        (``.pth``), the inverse of ``from_torch``. Unlike the JAX package's
        export, it needs no reference code: the port knows the key names."""
        torch.save(generator_state_to_torch(self.G), out_path)
        return out_path

    def labels(self, events: int) -> torch.Tensor:
        """Sensor labels 0..event_size-1, once per event."""
        return torch.arange(self.event_size, device=self.device).repeat(events)

    def draw(self, events: int, generator: torch.Generator | None = None):
        """``(z, rdof)`` for ``events`` events: standard normal draws on the
        model's device, z first."""
        n = self.event_size * events
        z = torch.randn((n, self.config["dim_z"]), generator=generator,
                        device=self.device, dtype=self.dtype)
        rdof = torch.randn((n, self.config["rdof_dim"]), generator=generator,
                           device=self.device, dtype=self.dtype)
        return z, rdof

    @torch.inference_mode()
    def events(self, z, rdof) -> torch.Tensor:
        """Generator forward + postprocess: (B, 250, W) float ADU in [0, 255]
        for B = events * event_size latents."""
        imgs = self.G(z, self.labels(z.shape[0] // self.event_size), rdof)
        return generate_postprocess(imgs.float(), threshold=-0.26)

    def draw_images(self, images: int, generator: torch.Generator | None = None):
        """``(z, labels)`` for ``images`` class-conditional samples on the
        model's device: z standard normal, then labels uniform over the
        ``n_classes`` classes, both from ``generator``."""
        z = torch.randn((images, self.config["dim_z"]), generator=generator,
                        device=self.device, dtype=self.dtype)
        labels = torch.randint(0, int(self.config["n_classes"]), (images,),
                               generator=generator, device=self.device)
        return z, labels


def generate_batched(model: Model, events_per_call: int,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """``events_per_call`` events in one generator call:
    (events_per_call * event_size, 250, W) ADU images on the model's device.
    Traced, the span ``ieagan.gen.call`` holds the host's issue of the call:
    the draw, G's forward and the postprocess."""
    with span("ieagan.gen.call"):
        return model.events(*model.draw(events_per_call, generator))


def sample_batched(model: Model, images_per_call: int,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """``images_per_call`` class-conditional images in one generator call:
    (images_per_call, H, W, C) in [-1, 1] on the model's device, from
    ``Model.draw_images`` (z, then labels uniform over the classes). The
    image twin of ``generate_batched``, under the same span
    ``ieagan.gen.call``: the draw and G's forward, no postprocess."""
    with span("ieagan.gen.call"), torch.inference_mode():
        return model.G(*model.draw_images(images_per_call, generator))


def generate_block(model: Model, events_per_call: int, chunks: int,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """``chunks * events_per_call`` events, one generator call per chunk,
    written into one preallocated output (the JAX package runs the chunks as
    one scanned program). Returns (chunks * events_per_call * event_size,
    250, W) on the model's device."""
    per_call = events_per_call * model.event_size
    out = None
    for i in range(chunks):
        imgs = generate_batched(model, events_per_call, generator)
        if out is None:
            out = torch.empty((chunks * per_call, *imgs.shape[1:]),
                              dtype=imgs.dtype, device=imgs.device)
        out[i * per_call:(i + 1) * per_call] = imgs
    return out


def generate(model: Model, generator: torch.Generator | None = None) -> np.ndarray:
    """One event: (event_size, 250, 768) float ADU in [0, 255] as a numpy
    array (reference contract: ieagan.py:1343-1366)."""
    return generate_batched(model, 1, generator).cpu().numpy()
