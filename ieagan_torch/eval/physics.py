"""Physics-stats evaluation (twin of ``ieagan_tpu/eval/physics.py``).

The reference's detector observables (reference: Evaluation/eval_all.py:75-120):
  * the ADU pixel-intensity spectrum over the bins [-1, 1, 7, 8..256]
    (eval_all.py:76);
  * the per-event occupancy (share of pixels above the 7-ADU cut) over 200
    bins in [0, 0.02] (eval_all.py:77);
  * the per-sensor mean charge over above-threshold pixels (eval_all.py:92-96).

``get_stats`` accumulates them on the host with numpy histograms from an
event stream; ``generate_stats`` generates the events and reduces them on
the generator's device (noise cut, crop, a sorted-search histogram, counts
and charge sums), so only per-event reductions reach the host. Draws come
from a ``torch.Generator`` seeded with ``seed`` on the generator's device,
in the same order in both, so a seed evaluates the same events.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ieagan_torch.utils.sampling import eval_mode

THRESHOLD = 7  # ADU noise cut (reference: eval_all.py:34)

INTENSITY_BINS = np.array([-1.0, 1.0, 7.0] + list(np.linspace(8, 256, 249)))
OCCUPANCY_BINS = np.linspace(0.0, 0.02, 201)


def log_transform_inv(img: np.ndarray) -> np.ndarray:
    """[-1, 1] model output -> ADU (reference: eval_all.py:104-106)."""
    img = 0.5 * (img + 1.0)
    return np.exp(np.log(256.0) * img) - 1.0


@dataclass
class EventStats:
    """Physics stats accumulated over a stream of event batches."""
    intensity_hist: np.ndarray = field(
        default_factory=lambda: np.zeros(len(INTENSITY_BINS) - 1, np.int64))
    occupancy_hist: np.ndarray = field(
        default_factory=lambda: np.zeros(len(OCCUPANCY_BINS) - 1, np.int64))
    mean_charges: list = field(default_factory=list)
    occupancies: list = field(default_factory=list)
    n_events: int = 0

    def update(self, imgs: np.ndarray):
        """imgs: (n_sensors, H, W) ADU images of one event, noise cut applied
        (pixels below the threshold set to 0)."""
        mask = imgs > 0
        self.intensity_hist += np.histogram(imgs.ravel(), INTENSITY_BINS)[0]
        occ_per_img = mask.mean(axis=(1, 2))
        self.occupancy_hist += np.histogram(occ_per_img, OCCUPANCY_BINS)[0]
        # a sensor with no above-threshold pixel gives NaN for this event and
        # is left out of its mean by nanmean (clamping the count would bias it
        # toward 0; the reference propagates the NaN)
        count = mask.sum(axis=(1, 2)).astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            self.mean_charges.append(np.where(mask, imgs, 0).sum(axis=(1, 2))
                                     / np.where(count > 0, count, np.nan))
        self.occupancies.append(occ_per_img)
        self.n_events += 1

    def summary(self) -> dict:
        return {
            "intensity_hist": self.intensity_hist,
            "intensity_bins": INTENSITY_BINS,
            "occupancy_hist": self.occupancy_hist,
            "occupancy_bins": OCCUPANCY_BINS,
            "per_sensor_mean_charge": np.nanmean(self.mean_charges, axis=0),
            "per_sensor_occupancy": np.mean(self.occupancies, axis=0),
            "n_events": self.n_events,
        }


def get_stats(event_stream, n_events: int = 100) -> dict:
    """Stats over an iterable of (imgs, labels) ADU events (reference:
    eval_all.py:75-101)."""
    acc = EventStats()
    for _, (imgs, _labels) in zip(range(n_events), event_stream):
        acc.update(np.asarray(imgs))
    return acc.summary()


def _adu_block(G, config: dict, generator: torch.Generator, events: int,
               dtype: torch.dtype) -> torch.Tensor:
    """``events`` events of G (labels 0..n-1 each) as noise-cut, cropped ADU:
    (events, n_classes, H-6, W) f32 on G's device. Draws z, then rdof, per
    event."""
    es, dim_z, rdof_dim = int(config["n_classes"]), int(config["dim_z"]), int(config["rdof_dim"])
    device = next(G.parameters()).device
    y = torch.arange(es, device=device)
    out = []
    with torch.inference_mode(), eval_mode(G):
        for _ in range(events):
            z = torch.randn((es, dim_z), generator=generator, device=device)
            rdof = torch.randn((es, rdof_dim), generator=generator, device=device)
            imgs = G(z.to(dtype), y, rdof).float()[..., 0]
            adu = torch.exp(math.log(256.0) * 0.5 * (imgs + 1.0)) - 1.0
            adu = torch.where(adu < THRESHOLD, torch.zeros_like(adu), adu)
            out.append(adu[:, 3:-3, :])
    return torch.stack(out)


def generate_event_stream(G, config: dict, seed: int = 0, events_per_call: int = 8,
                          dtype: torch.dtype = torch.float32):
    """Endless stream of noise-cut ADU events of G as numpy (reference:
    eval_all.py:109-120), ``events_per_call`` events per device block."""
    es = int(config["n_classes"])
    epc = max(1, int(events_per_call))
    generator = torch.Generator(device=next(G.parameters()).device).manual_seed(seed)
    labels = np.arange(es)
    while True:
        for ev in _adu_block(G, config, generator, epc, dtype).cpu().numpy():
            yield ev, labels


def _sorted_histogram(values: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """np.histogram's fixed-bin counts without a scatter: sort once, then
    each bin is a difference of insertion points. Bin i counts
    [e_i, e_{i+1}); the last bin includes its right edge (numpy's rule)."""
    s = torch.sort(values).values
    left = torch.searchsorted(s, edges, side="left")
    hist = left[1:] - left[:-1]
    hist[-1] = torch.searchsorted(s, edges[-1:], side="right")[0] - left[-2]
    return hist


def generate_stats(G, config: dict, n_events: int, seed: int = 0, events_per_call: int = 8,
                   dtype: torch.dtype = torch.float32) -> dict:
    """``EventStats`` with the reductions on G's device (reference protocol:
    Evaluation/eval_all.py:75-120 at 10k events). Histograms equal the host
    path's (the same f32 ADU values, integer bin edges; occupancies from the
    integer counts in f64 on the host); charge sums within f32 rounding. The
    draws follow ``generate_event_stream``'s, a whole block at a time, so
    the same seed evaluates the same events."""
    epc = max(1, int(events_per_call))
    device = next(G.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    edges = torch.as_tensor(INTENSITY_BINS, dtype=torch.float32, device=device)
    intensity_hist = np.zeros(len(INTENSITY_BINS) - 1, np.int64)
    cnts, csums = [], []
    done, t0 = 0, time.time()
    while done < n_events:
        block = _adu_block(G, config, generator, epc, dtype)
        take = min(epc, n_events - done)
        with torch.inference_mode():
            hist = sum(_sorted_histogram(ev.reshape(-1), edges) for ev in block[:take])
            cnt = (block[:take] > 0).sum(dim=(2, 3))
            csum = block[:take].sum(dim=(2, 3))
        intensity_hist += hist.cpu().numpy().astype(np.int64)
        cnts.append(cnt.cpu().numpy())
        csums.append(csum.cpu().numpy())
        if done and done % (50 * epc) < epc:
            print(f"[generate_stats] {done}/{n_events} events "
                  f"({done / (time.time() - t0):.1f} ev/s)", file=sys.stderr, flush=True)
        done += take
    cnt = np.concatenate(cnts).astype(np.float64)    # (n_events, es)
    csum = np.concatenate(csums).astype(np.float64)  # (n_events, es)
    n_pix = (int(config["resolution"]) - 6) * int(config["resolution"]) * int(config["H_base"])
    occ = cnt / n_pix
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_charges = csum / np.where(cnt > 0, cnt, np.nan)
    return {
        "intensity_hist": intensity_hist,
        "intensity_bins": INTENSITY_BINS,
        "occupancy_hist": np.histogram(occ.ravel(), OCCUPANCY_BINS)[0],
        "occupancy_bins": OCCUPANCY_BINS,
        "per_sensor_mean_charge": np.nanmean(mean_charges, axis=0),
        "per_sensor_occupancy": np.mean(occ, axis=0),
        "n_events": int(done),
    }


def real_event_stream(dataroot: str, seed: int = 0):
    """ADU event stream from a dataset directory (Evaluation/dataset.py)."""
    from ieagan_torch.data import ImageEventsDataset
    ds = ImageEventsDataset(dataroot, noise_scale=0.0)
    labels = np.arange(ds.n_sensors)
    for idx in np.random.default_rng(seed).permutation(len(ds)):
        imgs, _ = ds[idx]  # (es, H, W, 1) in [-1, 1] (lognormed)
        adu = log_transform_inv(imgs[..., 0])
        adu[adu < THRESHOLD] = 0.0
        yield adu[:, 3:-3, :], labels


def compare_models(models: dict, config: dict, n_events: int = 100,
                   real_dataroot: str | None = None, seed: int = 0) -> dict:
    """Stats per generator in ``models`` (name -> G), and for the real
    dataset when given (reference: eval_all.py:123-144)."""
    all_stats = {}
    if real_dataroot:
        all_stats["real"] = get_stats(real_event_stream(real_dataroot, seed), n_events)
    for name, G in models.items():
        all_stats[name] = get_stats(generate_event_stream(G, config, seed), n_events)
    return all_stats
