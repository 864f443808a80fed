"""Port vs JAX: ``PyGGATConv`` and ``PPIGAT`` against the JAX layers' fused
Pallas branch (``gat_attention`` over a ``block=True`` graph, in interpret
mode). The checks and their tolerances are those of
``tests/test_torch_ppi_models.py``, which holds the same cases against the
XLA branch; they sit in a file of their own so that the two run side by
side."""

import pytest

from efficient_gnns_tpu.ops import dispatch as jax_dispatch
from test_torch_ppi_models import CONV_CASES, check_conv, check_ppi_gat


@pytest.fixture
def pallas_interpret():
    jax_dispatch.set_backend("pallas", interpret=True)
    yield
    jax_dispatch.set_backend("auto", interpret=False)


@pytest.mark.parametrize("h,d,concat", CONV_CASES)
def test_pyg_gat_conv_matches_flax_fused_branch(rng, pallas_interpret, h, d, concat):
    check_conv(rng, True, h, d, concat)


def test_ppi_gat_matches_flax_fused_branch(rng, pallas_interpret):
    check_ppi_gat(rng, True, 3, num_layers=2)  # a hidden layer and the head mean
