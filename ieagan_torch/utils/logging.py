"""Logging sinks with the reference's on-disk formats (copy of
``ieagan_tpu/utils/logging.py``).

Two sinks (reference: utils/logging.py:8-90), byte-compatible so the
reference's analysis notebooks (log_read.ipynb) parse our logs unchanged:
  * MetricsLogger -> JSONL with a ``_stamp`` epoch-time field.
  * Logger -> one plaintext append-only ``<metric>.log`` per metric with
    ``"<itr>: <logstyle % value>"`` lines.
"""

from __future__ import annotations

import json
import pathlib
import time


class MetricsLogger:
    """JSONL metrics log (reference: utils/logging.py:8-39)."""

    def __init__(self, configuration: dict):
        self.metriclogpath = (
            pathlib.Path(configuration["outputroot"])
            / configuration["run_name"] / "logs"
            / configuration.get("metric_log_name", "metric_log.jsonl"))
        if configuration.get("reinitialize_metric_logs") and self.metriclogpath.exists():
            self.metriclogpath.unlink()

    def log(self, record=None, **kwargs):
        record = dict(record or {})
        record.update(kwargs)
        record["_stamp"] = time.time()
        with open(self.metriclogpath, "a", encoding="ascii") as fp:
            fp.write(json.dumps(record, ensure_ascii=True) + "\n")


class Logger:
    """Per-metric plaintext logs (reference: utils/logging.py:42-90)."""

    def __init__(self, configuration: dict):
        self.logroot = (pathlib.Path(configuration["outputroot"])
                        / configuration["run_name"] / "logs")
        self.reinitialize = configuration.get("reinitialize_parameter_logs", False)
        self.metrics: list[str] = []
        self.logstyle = configuration.get("logstyle", "%3.3e")

    def reinit(self, metric: str):
        path = self.logroot / f"{metric}.log"
        if path.exists() and self.reinitialize:
            path.unlink()

    def log(self, iteration: int, **kwargs):
        for metric, value in kwargs.items():
            if metric not in self.metrics:
                if self.reinitialize:
                    self.reinit(metric)
                self.metrics.append(metric)
            with open(self.logroot / f"{metric}.log", "a", encoding="ascii") as fp:
                fp.write(f"{iteration}: %s\n" % (self.logstyle % value))
