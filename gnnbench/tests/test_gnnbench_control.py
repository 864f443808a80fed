"""The precision controls on the card: the reference computed in the nearest
lower precision in the program's place fails a number that the cell holds to
a limit, while the program passes them all.

At a size a test run holds (40,000 nodes, 280,000 raw edges, enough for the
teacher's hub path), each cell with its own limits, on three seeds. The
readings at the cells' own size, which set the limits, are in ``PERF.md``
(``python -m gnnbench.calibrate ... --control``)."""

import pytest

from gnnbench import calibrate
from gnnbench.spec import Spec

CELLS = ("teacher-arxiv", "student-nce-arxiv", "student-kd-arxiv")
# the nearest precision below each one that a configuration states: float32
# products in TF32 (every cell); the teacher's bfloat16 hub messages in float8
CONTROLS = {"teacher-arxiv": ("tf32", "fp8_messages"), "student-nce-arxiv": ("tf32",),
            "student-kd-arxiv": ("tf32",)}


def _mid_spec(name):
    spec = Spec()
    cell = spec.cell(name)
    cfg = dict(spec.config(cell))
    cfg["graph"] = dict(cfg["graph"], num_nodes=40_000, num_edges=280_000)
    spec.config = lambda c: cfg
    return spec


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_precision_control_fails_and_the_program_passes(cuda, name):
    spec = _mid_spec(name)
    limits = spec.limits(spec.cell(name))
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        got = calibrate.readings(spec, name, seed, cuda, CONTROLS[name])
        over = {k: (got["program"][k], v) for k, v in limits.items() if got["program"][k] > v}
        assert not over, (seed, over)
        for c in CONTROLS[name]:
            control = got[f"control_{c}"]
            assert any(control[k] > v for k, v in limits.items()), (seed, c, control)
