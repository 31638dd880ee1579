"""Runs of a manifest's cells built without running them, as the readers'
tests need them: each declared by its cell's driver (``declare``), as the
driver declares a run on the card."""

from benchmark.harness import manifest
from benchmark.harness.run_state import Run


def declared(cell: str, traced: bool, config: dict | None = None, root=manifest.ROOT, **fields):
    """A ``Run`` of ``cell`` under ``config`` (by default the cell's
    configuration file's), declared by its driver, with ``fields`` set after."""
    c = manifest.cell(cell, root)
    r = Run(cell=c, config=dict(c.config_file["config"]) if config is None else config, seed=1,
            seconds=1.0, traced=traced)
    manifest.driver(c.kind, root).declare(r)
    for k, v in fields.items():
        setattr(r, k, v)
    return r
