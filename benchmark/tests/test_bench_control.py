"""The comparison that decides ``correct`` fails what it must: each cell
driven through the harness at a tiny width on the CPU (the look for a card
skipped), with the reference at the cell's control precision in the
program's place, and with each fault the cell can have planted in its timed
path. The program itself, in float32 here, passes."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import manifest

TINY = dict(resolution=64, G_ch=8, D_ch=8, H_base=2, n_classes=4, hypersphere_dim=64)
CELLS = [w["name"] for w in manifest.manifest()["workloads"]]
FAULTS = {"generate": ["altered"], "train": ["unchanged", "half_batch"]}
SEEDS = [2 ** 31 + 101, 3]


def tiny(cell, **extra):
    from ieagan_torch.core.config import DEFAULT_CONFIG
    return {**DEFAULT_CONFIG, **cell.config_file["config"], **TINY, **extra}


def drive(name, seed, mode="program", fault=None, **extra):
    cell = manifest.cell(name)
    return bench_run.measure(cell, seed, 0.05, False, torch.device("cpu"), mode=mode,
                             fault=fault, config=tiny(cell, **extra))


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes(name):
    run = drive(name, SEEDS[0], compute_dtype="float32")
    assert run.correct, [(c.name, c.value, c.limit) for c in run.checks]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name, seed):
    run = drive(name, seed, mode="control")
    assert not run.correct, [(c.name, c.value, c.limit) for c in run.checks]


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS
                                        for f in FAULTS[manifest.cell(n).kind]])
def test_each_fault_fails(name, fault):
    run = drive(name, SEEDS[0], fault=fault, compute_dtype="float32")
    assert not run.correct, [(c.name, c.value, c.limit) for c in run.checks]
