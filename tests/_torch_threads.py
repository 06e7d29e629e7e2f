"""The port's CPU tests run torch at one intra-op thread.  Not a test
module; each ``tests/test_torch_*.py`` that runs on the CPU imports the
fixture with ``from _torch_threads import _one_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on the host's cores, and idle threads spinning slow them all."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
