"""Drive every distillation mode of the row-sharded trainer
(``parallel.sharded_trainer``) on a world of ranks and hold each to the
single device: the representation modes of ``train/config.py`` and ``nce``
composed with logit KD, on the ``(D/2, 2)`` mesh and the halo partition of
the dryrun's GCN-KD section (``parallel.dryrun.build_inputs``).

    from efficient_gnns_tpu_torch.parallel.dryrun import build_inputs
    run_modes(build_inputs(4, "arxiv"), 4, backend="gloo", device="cuda")

The JAX dryrun trains ``kd`` only, and so does ``parallel/dryrun.py``; this
module is the port's own check of the other modes on row shards.

Each rank trains every case of ``CASES`` for ``STEPS`` steps, then
evaluates once. The GCN is the dryrun's (``SHAPES[shape]["gcn"]``); the
teacher's features are drawn on the rank's device from ``TEACHER_SEED`` at
``MODE_SHAPES[shape]["teacher_dim"]`` (750 at arxiv shape, the flagship
teacher's 3 x 250), and its logits are the dryrun's +4 / -2; ``lpw`` and
the ``*-edges`` modes read the train subgraph of the raw edges. A rank
returns, per case, its losses, host ms a step (the ranks start each step
together; synchronised on a card), K1 launches a step and in the
evaluation, and the bytes it sends a step (``parallel.dryrun._Clock``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from efficient_gnns_tpu_torch.parallel.launch import run_world

CASES = [(mode, False) for mode in ("fitnet", "at", "gpw", "lpw", "nce", "gcd", "nce-labels",
                                    "nce-edges", "nce-labels-edges")] + [("nce", True)]
MODE_SHAPES = {
    "tiny": dict(teacher_dim=24, proj_dim=16, max_samples=256),
    "arxiv": dict(teacher_dim=750, proj_dim=256, max_samples=8192),
}
TEACHER_SEED = 11
STEPS = 2  # train steps a case


def case_name(mode: str, kd_and_aux: bool) -> str:
    return mode + (" --kd_and_aux" if kd_and_aux else "")


def mode_config(shape: str, mode: str, kd_and_aux: bool):
    from efficient_gnns_tpu_torch.parallel.dryrun import SHAPES
    from efficient_gnns_tpu_torch.train.config import DistillConfig

    return DistillConfig(training=mode, kd_and_aux=kd_and_aux, **SHAPES[shape]["gcn"],
                         **{k: v for k, v in MODE_SHAPES[shape].items() if k != "teacher_dim"})


def teacher_features(num_rows: int, shape: str, device) -> torch.Tensor:
    """The whole graph's teacher features, drawn on ``device`` (a CPU and a
    card draw other values from one seed)."""
    gen = torch.Generator(device=device).manual_seed(TEACHER_SEED)
    return torch.randn(num_rows, MODE_SHAPES[shape]["teacher_dim"], generator=gen,
                       device=device)


def modes_rank(device: torch.device, inputs: Dict) -> Dict:
    """Every case on this rank: ``{case_name: {"losses", "ms", "k1_step",
    "k1_eval", "bytes_step", "digest"}}``."""
    from efficient_gnns_tpu_torch.parallel.dryrun import (
        _Clock,
        _digest,
        dp_mesh_shape,
        teacher_logits,
    )
    from efficient_gnns_tpu_torch.parallel.mesh import make_mesh
    from efficient_gnns_tpu_torch.parallel.sharded_trainer import ShardedNodeDistillTrainer

    d = dist.get_world_size()
    mesh = make_mesh(d, *dp_mesh_shape(d), device=device)
    shape = inputs["shape"]
    tf = teacher_features(inputs["x"].shape[0], shape, device)
    tl = teacher_logits(inputs["y"], inputs["num_classes"])
    clock = _Clock(device, STEPS)
    out = {}
    for mode, kd in CASES:
        name = case_name(mode, kd)
        cfg = mode_config(shape, mode, kd)
        tr = ShardedNodeDistillTrainer(
            mesh, cfg, inputs["halo_dp"], inputs["x"], inputs["y"], inputs["split_idx"],
            inputs["num_classes"], node_mask=inputs["node_mask"], teacher_feat=tf,
            teacher_logits=tl,
            lsp_graph=inputs["lsp_graph"] if cfg.needs_train_subgraph() else None, seed=0)
        losses = []
        clock(name, lambda: losses.append(list(tr.train_epoch(len(losses)).values())))
        clock(name + " eval", lambda: tr.evaluate(), reps=1)
        out[name] = dict(losses=losses, ms=clock.ms[name], k1_step=clock.launches[name],
                         k1_eval=clock.launches[name + " eval"], bytes_step=clock.sent[name],
                         digest=_digest({f"{m}.{k}": v for m, mod in tr._named_modules().items()
                                         for k, v in mod.state_dict().items()}))
        del tr
    return out


def single_device_modes(inputs: Dict, lsp_graph, device) -> Dict[str, List]:
    """Every case's losses on one device: ``NodeDistillTrainer`` on the
    whole graph, ``STEPS`` steps."""
    from efficient_gnns_tpu_torch.models import GCN
    from efficient_gnns_tpu_torch.parallel.dryrun import teacher_logits
    from efficient_gnns_tpu_torch.train.node_trainer import NodeDistillTrainer

    shape = inputs["shape"]
    tf = teacher_features(inputs["x"].shape[0], shape, device)
    tl = torch.as_tensor(teacher_logits(inputs["y"], inputs["num_classes"]), device=device)
    # moved once for every case
    graph, lsp_graph = inputs["graph"].to(device), lsp_graph.to(device)
    x, y = (torch.as_tensor(inputs[k], device=device) for k in ("x", "y"))
    out = {}
    for mode, kd in CASES:
        cfg = mode_config(shape, mode, kd)
        model = GCN(x.shape[1], cfg.hidden, inputs["num_classes"], cfg.num_layers,
                    cfg.dropout, seed=0, device=device)
        tr = NodeDistillTrainer(model, cfg, graph, x, y, inputs["split_idx"], teacher_feat=tf,
                                teacher_logits=tl,
                                lsp_graph=lsp_graph if cfg.needs_train_subgraph() else None,
                                seed=0, device=device)
        out[case_name(mode, kd)] = [list(tr.train_epoch(e).values()) for e in range(STEPS)]
        del tr
    return out


def rank_inputs(inputs: Dict) -> Dict:
    """What the ranks of :func:`modes_rank` share: ``inputs`` (from
    ``parallel.dryrun.build_inputs``) less the whole graph and the flat
    partitions, with the train subgraph of the raw edges (``"lsp_graph"``)."""
    from efficient_gnns_tpu_torch.graphs import induced_subgraph

    senders, receivers = inputs["edges"]
    skip = ("graph", "edges", "halo", "allg")
    return dict({k: v for k, v in inputs.items() if k not in skip},
                lsp_graph=induced_subgraph(senders, receivers, inputs["split_idx"]["train"]))


def check_modes(inputs: Dict, shared: Dict, ranks: List[Dict], device) -> Dict:
    """The single device on ``device`` beside the ranks' results of
    :func:`modes_rank` on ``shared``. Returns every rank's results
    (``"ranks"``), the single device's losses (``"single"``), the train
    subgraph (``"lsp_graph"``), its node count and the failures: a loss
    that is not finite, a rank whose losses or replicated parameters differ
    from rank 0's, a loss beyond rtol 1e-5 of the single device's."""
    single = single_device_modes(inputs, shared["lsp_graph"], device)
    failures = []
    for name, want in single.items():
        got = ranks[0][name]["losses"]
        if not np.isfinite(got).all():
            failures.append(f"{name}: a loss is not finite: {got}")
        if any(r[name]["losses"] != got or r[name]["digest"] != ranks[0][name]["digest"]
               for r in ranks):
            failures.append(f"{name}: the ranks disagree")
        if not np.allclose(got, want, rtol=1e-5, atol=0.0):
            failures.append(f"{name}: losses {got} != single device {want}")
    return dict(ranks=ranks, single=single, failures=failures, lsp_graph=shared["lsp_graph"],
                n_train=int(np.asarray(inputs["split_idx"]["train"]).size))


def run_modes(inputs: Dict, n_devices: int, *, backend: str = "nccl",
              device: str = "cuda") -> Dict:
    """:func:`modes_rank` on a world of ``n_devices`` ranks, then
    :func:`check_modes` on ``device``."""
    shared = rank_inputs(inputs)
    ranks = run_world(modes_rank, n_devices, backend=backend, device=device, args=(shared,))
    return check_modes(inputs, shared, ranks, device)
