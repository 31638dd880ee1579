"""Host-side input pipeline: threaded decode, bounded prefetch, and the copy
to the device (twin of ``ieagan_tpu/data/pipeline.py``).

Replaces the reference's DataLoader worker processes (reference:
utils/dataloader.py:81, num_workers=8) with a thread pool (PIL decode
releases the GIL) and a bounded prefetch queue; batches are flattened to
(events*event_size, H, W, 1). With ``device`` set to a CUDA device, the
producer thread pins each batch and copies it there on a stream of its own,
so the upload overlaps the previous step; the consumer's stream waits for
the copy before the batch is used. Traced, the consumer's wait for the next
batch is the span ``ieagan.data.wait``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ieagan_torch.core.spans import span


class EventLoader:
    """Iterable over (images, labels) batches of whole events: numpy arrays,
    or tensors on ``device`` (labels int64) when it is set.

    Several processes: pass ``process_index``/``process_count`` (default 0
    and 1). Each process decodes only every ``process_count``-th event of a
    seed-consistent global shuffle; ``events_per_batch`` stays the global
    batch size and each process yields its local share.
    """

    def __init__(self, dataset, num_workers: int = 8, shuffle: bool = True,
                 seed: int | None = None, events_per_batch: int = 1,
                 prefetch: int = 2, device=None, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.events_per_batch = events_per_batch
        self.prefetch = prefetch
        self.device = device
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        if events_per_batch % self.process_count:
            raise ValueError(
                f"events_per_batch={events_per_batch} must divide evenly "
                f"over {self.process_count} processes")
        self._epb_local = events_per_batch // self.process_count
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Seed the shuffle epoch counter (resume path).

        Each ``__iter__`` draws its permutation from ``(seed, _epoch)`` and
        then increments ``_epoch``; a driver resuming at epoch E must seed
        this so the resumed run continues the epoch-E order instead of
        silently re-visiting epoch 0's.
        """
        self._epoch = int(epoch)

    def __len__(self):
        n_local = len(self.dataset) // self.process_count
        n = n_local // self._epb_local
        if not self.drop_last and n_local % self._epb_local:
            n += 1
        return n

    def _order(self):
        """This process's slice of the seed-consistent global order."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            seed = self.seed
            if seed is None and self.process_count > 1:
                # processes must agree on the global permutation without a
                # collective; warn that run-to-run order is then fixed
                if not getattr(self, "_warned_seed", False):
                    self._warned_seed = True
                    print("EventLoader: multi-process shuffle with seed=None "
                          "uses a fixed seed (identical order every run) — "
                          "pass an explicit seed for run-to-run variation")
                seed = 0
            rng = np.random.default_rng(
                None if seed is None else (seed, self._epoch))
            rng.shuffle(idx)
        local = idx[self.process_index::self.process_count]
        if self.process_count > 1:
            # equal local counts on every process (strided slicing gives the
            # low ranks one extra when N % P != 0, which would desynchronize
            # the tail batch of a drop_last=False epoch)
            local = local[:len(self.dataset) // self.process_count]
        return local

    def _upload(self, imgs: np.ndarray, labels: np.ndarray, stream):
        """``(images, labels, copy event or None)`` on the loader's device."""
        device = torch.device(self.device)
        x, y = torch.from_numpy(imgs), torch.from_numpy(labels).long()
        if device.type != "cuda":
            return x.to(device), y.to(device), None
        with torch.cuda.stream(stream):
            x = x.pin_memory().to(device, non_blocking=True)
            y = y.pin_memory().to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return x, y, done

    def __iter__(self):
        order = self._order()
        self._epoch += 1
        epb = self._epb_local
        n_batches = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        errors: list = []
        on_cuda = self.device is not None and torch.device(self.device).type == "cuda"
        stream = torch.cuda.Stream(device=self.device) if on_cuda else None

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        ids = order[b * epb:(b + 1) * epb]
                        items = list(pool.map(self.dataset.__getitem__, ids))
                        imgs = np.concatenate([im for im, _ in items], axis=0)
                        labels = np.concatenate([lb for _, lb in items], axis=0)
                        if self.device is not None:
                            q.put(self._upload(imgs, labels, stream))
                        else:
                            q.put((imgs, labels, None))
            except Exception as e:  # noqa: BLE001 — re-raised in the consumer
                errors.append(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                with span("ieagan.data.wait"):
                    item = q.get()
                if item is None:
                    if errors:  # a failed decode or upload ends the epoch with its error
                        raise errors[0]
                    return
                imgs, labels, done = item
                if done is not None:
                    current = torch.cuda.current_stream(imgs.device)
                    current.wait_event(done)
                    imgs.record_stream(current)
                    labels.record_stream(current)
                yield imgs, labels
        finally:
            stop.set()


def synthetic_events(config: dict, n_batches: int = 10, seed: int = 0):
    """Synthetic event stream with the real pipeline's shapes/ranges — the
    debug/data-free path (analog of the reference's --debug dummy loop,
    train.py:147-149)."""
    es = int(config["n_classes"])
    epb = int(config.get("events_per_batch", 1))
    h = int(config["resolution"])
    w = h * int(config["H_base"])
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        imgs = rng.uniform(-1.0, 1.0, (es * epb, h, w, 1)).astype(np.float32)
        labels = np.tile(np.arange(es, dtype=np.int32), epb)
        yield imgs, labels
