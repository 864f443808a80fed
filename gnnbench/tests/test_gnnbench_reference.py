"""The plain reference held against the program on the CPU at small sizes:
the graph and its normalisation, the hub path's edge-drop masks, and the
first steps of each cell."""

import numpy as np
import pytest
import torch

from efficient_gnns_tpu_torch.graphs.preprocess import build_graph
from efficient_gnns_tpu_torch.ops.hub_attention import hub_keep_weights
from gnnbench import calibrate, data
from gnnbench.reference import graph as ref_graph
from gnnbench.tests.conftest import SMALL_GRAPH, small_spec

CPU = torch.device("cpu")


def _task(seed):
    return data.arxiv_task(dict(small_spec("student-kd-arxiv").config(None)["graph"]), seed)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_graph_order_degrees_and_norm_equal_the_programs(seed):
    t = _task(seed)
    prog = build_graph(t.senders, t.receivers, t.num_nodes, bidirected=True, self_loops=True,
                       gcn_norm=True)
    ref = ref_graph.arxiv_graph(t.senders, t.receivers, t.num_nodes, CPU, gcn_norm=True)
    e = prog.n_edge
    assert ref.num_edges == e
    assert torch.equal(prog.senders[:e].long(), ref.senders)
    assert torch.equal(prog.receivers[:e].long(), ref.receivers)
    assert torch.equal(prog.in_degrees(), ref.in_deg)
    assert torch.equal(prog.out_degrees(), ref.out_deg)
    assert torch.equal(prog.edge_weight[:e], ref.norm)


@pytest.mark.parametrize("width", [16, 64])
def test_edge_drop_masks_equal_the_programs(width):
    t = _task(3)
    prog = build_graph(t.senders, t.receivers, t.num_nodes, bidirected=True, self_loops=True,
                       hub_dense=width)
    ref = ref_graph.arxiv_graph(t.senders, t.receivers, t.num_nodes, CPU, hub_width=width)
    assert int((ref.hub.kind > 0).sum()) > 0
    for seed in (0, 12345, 2**32 - 1):
        s = torch.tensor(seed, dtype=torch.int64)
        want = hub_keep_weights(prog, s, 0.7)[: prog.n_edge]
        assert torch.equal(ref_graph.edge_keep(ref, s, 0.7), want)


def test_auto_hub_width_follows_the_rule():
    assert ref_graph.auto_hub_width(169343, 1_880_000) == 512
    assert ref_graph.auto_hub_width(400_000, 1_880_000) == 256
    assert ref_graph.auto_hub_width(SMALL_GRAPH["num_nodes"], 199_999) == 0


# the largest gaps of the program's first steps at a CPU test's size: float32
# paths agree to rounding; the teacher's bfloat16 hub messages round apart
# where the two sides' float32 values straddle a bfloat16 step
FLOAT32 = {"loss": 1e-5, "loss1": 1e-5, "grad": 1e-5, "change": 1e-4, "first_layer": 1e-5}
CASES = [
    ("teacher-arxiv", {"hub_message_dtype": "float32"},
     dict(FLOAT32, eval=1e-5, eval_rms=1e-5, best=1e-5)),
    ("teacher-arxiv", {}, {"loss": 1e-3, "grad": 3e-3, "change": 3e-2, "eval_rms": 1e-2,
                           "first_layer": 1e-5, "best": 1e-2}),
    ("student-nce-arxiv", {}, FLOAT32),
    ("student-kd-arxiv", {}, FLOAT32),
]


@pytest.mark.parametrize("name,changes,bounds", CASES,
                         ids=["teacher-f32", "teacher-bf16", "student-nce", "student-kd"])
def test_first_steps_follow_the_program(name, changes, bounds):
    spec = small_spec(name, **changes)
    got = calibrate.readings(spec, name, 11, CPU, half_batch=True)
    for k, bound in bounds.items():
        assert got["program"][k] <= bound, (k, got["program"])
    # the planted fault is far outside
    assert max(got["half_batch"][k] for k in ("grad", "change")) > 1e-2


def test_the_students_still_leaf_is_the_bias_before_batchnorm():
    got = calibrate.readings(small_spec("student-kd-arxiv"), "student-kd-arxiv", 4, CPU)
    assert got["still_leaves"] == ["0.convs.0.bias"]


def test_inputs_repeat_for_a_seed_and_differ_between_seeds():
    a, b, c = _task(2**31 + 1), _task(2**31 + 1), _task(2**31 + 2)
    assert np.array_equal(a.senders, b.senders) and np.array_equal(a.x, b.x)
    assert not np.array_equal(a.senders, c.senders)
    shapes = {"w": (3, 4), "bn.scale": (4,), "bn.running_var": (4,), "b": (4,)}
    s1 = data.initial_state(shapes, 7, CPU)
    s2 = data.initial_state(shapes, 7, CPU)
    assert all(torch.equal(s1[k], s2[k]) for k in shapes)
    assert torch.equal(s1["bn.scale"], torch.ones(4)) and torch.equal(s1["b"], torch.zeros(4))
    assert float(s1["w"].abs().max()) <= (6 / 7) ** 0.5
