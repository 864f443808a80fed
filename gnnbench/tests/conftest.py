"""The benchmark's own tests: ``python -m pytest gnnbench/tests``.

Tests that need a CUDA card are marked ``gpu`` and take the ``cuda``
fixture, which skips them where there is none (decided in the fixture, never
at import). On the card: ``python -m pytest gnnbench/tests -m gpu``.
"""

import pytest
import torch

from gnnbench.spec import Spec


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


SMALL_GRAPH = {"num_nodes": 2000, "num_edges": 10000}


def small_spec(name: str, **cfg_changes) -> Spec:
    """The benchmark's spec with cell ``name`` cut to a CPU test's size: a
    graph of 2,000 nodes, a hub width of 64, teacher heads 20 wide and an
    InfoNCE sample of 256 rows; ``cfg_changes`` override configuration keys."""
    spec = Spec()
    cell = spec.cell(name)
    cfg = dict(spec.config(cell))
    cfg["graph"] = dict(cfg["graph"], **SMALL_GRAPH)
    if "n_hidden" in cfg:
        cfg.update(n_hidden=20, hub_dense=64)
    cfg.update(cfg_changes)
    traffic = dict(spec.traffic(cell))
    if "max_samples" in traffic:
        traffic["max_samples"] = 256
    spec.config = lambda c: cfg
    spec.traffic = lambda c: traffic
    return spec
