"""``epoch_p95_ms`` in the student cells, per layer and with no bound: the
host's pace of the trainer's launches sets the tail of a 10 to 21 ms epoch,
so it swings with the host from check to check."""

from gnnbench.metrics.epoch_p95_ms import read  # noqa: F401
