"""Analysis tooling (counterpart of ``efficient_gnns_tpu/analysis``):
learning curves, embedding-structure correlations, timing and traces
(``timing.py``) and the micro-benchmarks (``microbench.py``)."""

from efficient_gnns_tpu_torch.analysis.curves import plot_curves
from efficient_gnns_tpu_torch.analysis.correlation import (
    edge_cosine_distance,
    linear_cka,
    mantel_correlation,
    pairwise_cosine_distance_condensed,
    structure_report,
)

__all__ = [
    "plot_curves",
    "edge_cosine_distance",
    "linear_cka",
    "mantel_correlation",
    "pairwise_cosine_distance_condensed",
    "structure_report",
]
