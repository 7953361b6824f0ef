"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the repository's
root. Tests marked ``card`` need a CUDA device and skip without one; they decide inside the
test, never while a module is imported."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a card test")
    return torch.device("cuda")
