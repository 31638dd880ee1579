"""Mass production into basf2: sparse digits and a producer/consumer
pipeline (twin of ``ieagan_tpu/deploy/producer.py``; reference:
Physics_Analysis/create_g1.py).

The reference runs N torch producer processes that each call generate() and
push sparse digits into a queue, and a basf2 ``Module`` that pops one event
per event() call and appends PXDDigits (create_g1.py:62-122, 167-195). Here
one thread drives the card with ``generate_block`` and extracts each event's
digits on the host with the C++ library (``csrc/sparse_digits.cpp``, called
through ctypes, which releases the GIL), feeding a bounded queue. ``get()``
returns one event's (coords, charges), coords rows (sensor, row, col).

The library is compiled at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``ieagan_torch/kernels/_build/`` (ignored by git), its file
name keyed by a hash of the source and the flags; ``$CXX`` names another
compiler. A failed build or load raises: there is no silent fallback.
``extract_sparse_digits_plain`` is the numpy version the tests hold it to.

basf2: ``make_digit_creator`` mirrors the reference's basf2.Module
(create_g1.py:97-112) when basf2 is importable; otherwise ``NpzWriter``
persists events for offline injection.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ieagan_torch.kernels import build as kernel_build

NATIVE_SOURCE = Path(__file__).resolve().parent / "csrc" / "sparse_digits.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_NATIVE: ctypes.CDLL | None = None


def native_library_path() -> Path:
    """Where the library is built: the name hashes the source and flags."""
    digest = hashlib.sha256(NATIVE_SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return kernel_build.BUILD_DIR / f"sparse_digits-{digest.hexdigest()[:16]}.so"


def build_native() -> dict:
    """Compile the library unless it is built; ``{"path", "seconds"}``.
    Raises ``RuntimeError`` if the compiler fails or is missing."""
    out = native_library_path()
    if out.exists():
        return {"path": out, "seconds": 0.0}
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"sparse-digit library: cannot run {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"sparse-digit library build failed ({' '.join(cmd)}, exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return {"path": out, "seconds": time.perf_counter() - t0}


def load_native() -> ctypes.CDLL:
    """The sparse-digit library, built first if needed (ctypes contract of
    ``ieagan_tpu/deploy/producer.py:51-56``)."""
    global _NATIVE
    if _NATIVE is None:
        lib = ctypes.CDLL(str(build_native()["path"]))
        lib.extract_digits.restype = ctypes.c_int64
        lib.extract_digits.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64]
        _NATIVE = lib
    return _NATIVE


def extract_sparse_digits(imgs: np.ndarray, threshold: float = 0.0):
    """(n, h, w) float ADU images -> (coords (m, 3) int32, charges (m,)
    uint8) through the C++ library.

    coords rows are (image_index, row, col); a charge is the uint8-truncated
    ADU value, saturated at 255 (reference: create_g1.py:74-78)."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    if imgs.ndim != 3:
        raise ValueError(f"expected (n, h, w) images, got shape {imgs.shape}")
    n, h, w = imgs.shape
    lib = load_native()
    cap = int((imgs > threshold).sum())
    coords = np.empty((max(cap, 1), 3), np.int32)
    charges = np.empty(max(cap, 1), np.uint8)
    m = lib.extract_digits(imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, h, w,
                           ctypes.c_float(threshold),
                           coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                           charges.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if m != cap:
        raise RuntimeError(f"sparse-digit library counted {m} digits, numpy {cap}")
    return coords[:m], charges[:m]


def extract_sparse_digits_plain(imgs: np.ndarray, threshold: float = 0.0):
    """The numpy version of ``extract_sparse_digits``."""
    imgs = np.asarray(imgs, np.float32)
    mask = imgs > threshold
    return np.argwhere(mask).astype(np.int32), np.clip(imgs[mask], 0, 255).astype(np.uint8)


class EventProducer:
    """Generate events on the model's device and queue their sparse digits.

    ``model``: a ``deploy.Model``. One background thread calls
    ``generate_block(model, events_per_call, chunks, generator)`` with a
    ``torch.Generator`` seeded with ``seed`` on the model's device, copies
    each block to the host once and extracts its events' digits. ``get()``
    pops one event's digits; ``None`` marks the end. An error in the thread
    ends the stream and is raised by ``get()``.
    """

    def __init__(self, model, num_events: int | None = None, events_per_call: int = 4,
                 max_queue: int = 64, seed: int = 0, chunks: int = 4):
        from ieagan_torch.deploy.inference import generate_block
        self._generate = lambda generator: generate_block(model, events_per_call, chunks,
                                                          generator)
        self.device = model.device
        self.event_size = model.event_size
        self.events_per_call = events_per_call * chunks
        self.num_events = num_events
        self.seed = seed
        self.queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _put(self, item) -> bool:
        """Queue ``item`` unless ``stop()`` is called while the queue is full."""
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            generator = torch.Generator(device=self.device).manual_seed(self.seed)
            produced, es = 0, self.event_size
            while not self._stop.is_set():
                if self.num_events is not None and produced >= self.num_events:
                    break
                block = self._generate(generator).cpu().numpy()  # (epc * es, 250, W)
                for e in range(self.events_per_call):
                    if not self._put(extract_sparse_digits(block[e * es:(e + 1) * es])):
                        return
                    produced += 1
                    if self.num_events is not None and produced >= self.num_events:
                        break
        except Exception as e:  # noqa: BLE001 — handed to the consumer by get()
            self.error = e
        self._put(None)  # sentinel

    def get(self, timeout: float | None = None):
        item = self.queue.get(timeout=timeout)
        if item is None and self.error is not None:
            raise RuntimeError("the event producer failed") from self.error
        return item

    def stop(self):
        self._stop.set()

    def join(self, timeout: float | None = None):
        self._thread.join(timeout)

    def __iter__(self):
        while True:
            item = self.get()
            if item is None:
                return
            yield item


class NpzWriter:
    """Offline sink: produced events as compressed npz shards (consumed later
    by a basf2 injection job); the JAX package's shard format."""

    def __init__(self, out_dir: str, events_per_shard: int = 100):
        self.out_dir = out_dir
        self.events_per_shard = events_per_shard
        os.makedirs(out_dir, exist_ok=True)
        self._buf: list = []
        self._shard = 0

    def write(self, digits):
        self._buf.append(digits)
        if len(self._buf) >= self.events_per_shard:
            self.flush()

    def flush(self):
        if not self._buf:
            return
        arrays = {}
        for i, (coords, charges) in enumerate(self._buf):
            arrays[f"coords_{i}"] = coords
            arrays[f"charges_{i}"] = charges
        path = os.path.join(self.out_dir, f"events_{self._shard:05d}.npz")
        np.savez_compressed(path, n_events=len(self._buf), **arrays)
        self._buf = []
        self._shard += 1


def make_digit_creator(producer: EventProducer):
    """basf2 Module that appends one queued event's PXDDigits per event()
    call (reference: create_g1.py:97-112); None when basf2 is not
    importable (use ``NpzWriter`` there)."""
    try:
        import basf2
        from ROOT import Belle2  # noqa: F401
    except ImportError:
        return None

    class DigitCreator(basf2.Module):
        def initialize(self):
            from ROOT import Belle2
            self.digits = Belle2.PyStoreArray("PXDDigits")
            self.digits.registerInDataStore()
            self.vxd_ids = [  # 40 PXD sensors, layer.ladder.sensor
                Belle2.VxdID(1, ladder, sensor) for ladder in range(1, 9) for sensor in (1, 2)
            ] + [
                Belle2.VxdID(2, ladder, sensor) for ladder in range(1, 13) for sensor in (1, 2)
            ]

        def event(self):
            from ROOT import Belle2
            item = producer.get()
            if item is None:
                return
            coords, charges = item
            for (sensor, row, col), charge in zip(coords, charges):
                digit = self.digits.appendNew()
                digit.__assign__(Belle2.PXDDigit(self.vxd_ids[int(sensor)], int(col), int(row),
                                                 int(charge)))

    return DigitCreator()


def produce_events(model, num_events: int, out_dir: str | None = None,
                   events_per_call: int = 4, seed: int = 0) -> int:
    """Produce ``num_events`` events; feed basf2 when it is importable, else
    write npz shards (reference: create_g1.py run(), 124-195)."""
    producer = EventProducer(model, num_events=num_events, events_per_call=events_per_call,
                             seed=seed).start()
    try:
        creator = make_digit_creator(producer)
        if creator is not None:
            import basf2
            path = basf2.Path()
            path.add_module("EventInfoSetter", evtNumList=[num_events])
            path.add_module(creator)
            if out_dir:
                path.add_module("RootOutput",
                                outputFileName=os.path.join(out_dir, "pxd_digits.root"))
            basf2.process(path)
            return num_events
        writer = NpzWriter(out_dir or "produced_events")
        n = 0
        for digits in producer:
            writer.write(digits)
            n += 1
        writer.flush()
        return n
    finally:
        producer.stop()
