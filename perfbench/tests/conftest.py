"""The benchmark's own tests: on the CPU at small sizes, and, marked
``card``, on the H100 at the cells' sizes (``python -m pytest perfbench/tests
-m card`` there; they skip elsewhere).  Nothing here imports JAX."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the H100 (perfbench/README.md)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests start several ranks side by side."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
