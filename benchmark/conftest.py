"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``chip`` marker for tests that need a CUDA device,
which skip elsewhere by the ``cuda_device`` fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (an H100); skips where none is found")


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a chip test, run on the H100")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Torch on two threads: the tests run tiny models, several at once."""
    import torch
    torch.set_num_threads(2)
