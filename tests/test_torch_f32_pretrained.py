"""The pretrained-weight facades in their default config (float32 all through) on the CPU,
the port against the JAX package: ``AuroraHighRes``, ``Aurora12hPretrained`` and
``AuroraPretrained``, the rest of ``tests/test_torch_f32_variants.py``'s check (its
docstring), cut to widths of 64 and two blocks a stage, two roll-out steps, mean relative
error per variable <= 1e-5."""

import pytest
import torch

from tests.test_torch_f32_variants import check_default_config


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["AuroraHighRes", "Aurora12hPretrained", "AuroraPretrained"])
def test_default_config_matches_jax_in_float32(name):
    check_default_config(name)
