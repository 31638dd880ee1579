"""Log parsing utilities (copy of ``ieagan_tpu/utils/log_read.py``) — the
programmatic analog of the reference's
notebooks/log_read.ipynb (parse ``<metric>.log`` plaintext and the
``metric_log.jsonl`` stream into arrays/frames for analysis)."""

from __future__ import annotations

import json
import pathlib

import numpy as np


def read_metric_log(path) -> tuple[np.ndarray, np.ndarray]:
    """Parse a '<itr>: <value>' plaintext metric log
    (written by utils.logging.Logger)."""
    itrs, vals = [], []
    for line in pathlib.Path(path).read_text().splitlines():
        if ":" not in line:
            continue
        itr, val = line.split(":", 1)
        itrs.append(int(itr))
        vals.append(float(val))
    return np.asarray(itrs), np.asarray(vals)


def read_all_metric_logs(logs_dir) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    out = {}
    for path in sorted(pathlib.Path(logs_dir).glob("*.log")):
        try:
            out[path.stem] = read_metric_log(path)
        except ValueError:
            continue
    return out


def read_jsonl(path) -> list[dict]:
    """Parse a MetricsLogger jsonl stream."""
    records = []
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            records.append(json.loads(line))
    return records


def sv_spectra(logs_dir, prefix: str = "G") -> dict[str, np.ndarray]:
    """Collect SN singular-value trajectories per layer (the notebook's SV
    spectra figure)."""
    out = {}
    for name, (itrs, vals) in read_all_metric_logs(logs_dir).items():
        if name.startswith(prefix) and name.endswith("_sv"):
            out[name] = np.stack([itrs, vals])
    return out
