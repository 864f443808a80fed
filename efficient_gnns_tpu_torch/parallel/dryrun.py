"""Drive every path of the multi-device layer once on a world of ranks
(counterpart of ``dryrun_multichip`` in the JAX repository's
``__graft_entry__.py``).

    python -m efficient_gnns_tpu_torch.parallel.dryrun 4 --backend gloo --device cuda
    python -m efficient_gnns_tpu_torch.parallel.dryrun 4 --backend gloo --device cpu

Each rank runs, in order:

1. the data-parallel GCN-KD section: ``ShardedNodeDistillTrainer`` (the
   JAX ``NodeDistillTrainer`` with ``x`` / ``y`` under ``shard_rows``) on a
   ``(D/2, 2)`` ``("data", "model")`` mesh, the rows over ``data`` and
   replicated over ``model`` (a 1-D ``(D,)`` mesh for an odd world): train
   steps, then an evaluation;
2. the SIGN dp x tp section on the same mesh: ``sign_dp_tp_step``, the batch
   rows over ``data`` and the hidden-width kernels over ``model``, the last
   step's collectives timed inside it (their share of the step); skipped,
   saying so, for an odd world;
3. the halo-partition GCN step: ``spmm_halo(x @ w)``, log-softmax NLL as a
   mean over every real node, one SGD step of the replicated ``w`` with its
   gradient summed over the ranks; then the step's halo exchange alone
   (timed: its share of the step);
4. ``spmm_sharded`` and ``spmm_halo`` forward and backward of
   ``sum(sin(A @ x))``;
5. the ring InfoNCE term and its gradient;
6. the two-level ``(2, D/2)`` halo step, whose loss must equal the flat
   one's bits (skipped, saying so, for an odd world);
7. the MAG R-GCN step with the embedding tables row-sharded
   (``MagTrainer.shard_embeddings``).

``shape="tiny"`` is the JAX dryrun's size (a GCN 2 x 16 in ``kd`` against
the +4 / -2 teacher logits; SIGN 3 hops x 64, batch 256, dropout 0.1);
``shape="arxiv"`` the synthetic ogbn-arxiv graph (169,343 nodes, padded to a
multiple of the world) with F_in = 128 and 40 classes: the GCN student 2 x
256 in ``kd`` (alpha 0.9, T 4), SIGN at ``cli/sign.py``'s defaults (6 hops x
512, batch 50,000, dropout 0.5), F = 256 for the SpMMs, the ``nce`` mode's
8,192 x 256 for the ring, and a MAG at the teacher's widths (3 x 512, 349
classes) on a twentieth of ogbn-mag's node counts, 2 steps. The GCN-KD,
SIGN and halo steps' losses are checked against the single-device ones on
the caller's device (rtol 1e-5), and the replicated parameters must hold
the same bits on every rank.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from efficient_gnns_tpu_torch.parallel.launch import run_world

SHAPES = {
    "tiny": dict(num_nodes=1024, num_edges=4096, feat_dim=32, num_classes=8, seed=0,
                 spmm_feat=16, nce_rows=1024, nce_dim=16,
                 mag=dict(n_paper=320, n_author=160, n_inst=8, n_field=32, feat_dim=16,
                          num_classes=4),
                 mag_hidden=8, mag_layers=2, mag_batch=32, mag_steps=1, reps=1,
                 gcn=dict(hidden=16, num_layers=2, dropout=0.5),
                 sign=dict(hops=3, hidden=64, batch=256, dropout=0.1)),
    "arxiv": dict(num_nodes=169343, num_edges=1166243, feat_dim=128, num_classes=40, seed=42,
                  spmm_feat=256, nce_rows=8192, nce_dim=256,
                  mag=dict(n_paper=36819, n_author=56732, n_inst=437, n_field=2998,
                           feat_dim=128, num_classes=349),
                  mag_hidden=512, mag_layers=3, mag_batch=1000, mag_steps=2, reps=3,
                  gcn=dict(hidden=256, num_layers=2, dropout=0.5),
                  sign=dict(hops=6, hidden=512, batch=50000, dropout=0.5)),
}


# the JAX step's SIGN widths beside the shape's: 2 layers a block, Adam lr
# 1e-3, the same dropout key at every step, features and labels from seed 0
SIGN_FF_LAYERS, SIGN_LR, SIGN_DROPOUT_SEED, SIGN_DATA_SEED = 2, 1e-3, 2, 0


def dp_mesh_shape(n_devices: int):
    """The JAX dryrun's ``(D/2, 2)`` ``("data", "model")`` mesh; ``(D,)``
    ``("data",)`` for an odd world, where the SIGN section is skipped."""
    if n_devices % 2:
        return ("data",), (n_devices,)
    return ("data", "model"), (n_devices // 2, 2)


def build_inputs(n_devices: int, shape: str = "tiny") -> Dict:
    """Everything the ranks share, built once on the host: the graph padded
    to a multiple of the world, its partitions (flat ``n_devices``, and halo
    over the GCN-KD mesh's ``data`` axis), the features, labels, splits and
    node mask, the step's initial ``w``; and the graph's raw edges (not
    sent to the dryrun's ranks)."""
    from efficient_gnns_tpu_torch.data import synthetic_node_dataset
    from efficient_gnns_tpu_torch.parallel.partition import partition_graph, partition_graph_halo

    cfg = SHAPES[shape]
    n = cfg["num_nodes"]
    ds = synthetic_node_dataset(num_nodes=n, num_edges=cfg["num_edges"],
                                feat_dim=cfg["feat_dim"], num_classes=cfg["num_classes"],
                                seed=cfg["seed"], pad_nodes_to=-(-n // n_devices) * n_devices,
                                hub_dense=0)
    w = np.random.default_rng(1).normal(size=(cfg["feat_dim"], cfg["num_classes"]))
    return dict(shape=shape, graph=ds.graph, x=ds.x, y=ds.y.astype(np.int64),
                # a copy: pickling the graph for the ranks moves its tensors'
                # storage to shared memory, which would leave a view dangling
                node_mask=ds.graph.node_mask.numpy().copy(), n_real=n,
                w=(w * 0.1).astype(np.float32), split_idx=ds.split_idx,
                num_classes=cfg["num_classes"],
                halo=partition_graph_halo(ds.graph, n_devices),
                halo_dp=partition_graph_halo(ds.graph, dp_mesh_shape(n_devices)[1][0]),
                allg=partition_graph(ds.graph, n_devices),
                edges=(ds.senders, ds.receivers))


def teacher_logits(y: np.ndarray, num_classes: int) -> np.ndarray:
    """The JAX dryrun's teacher: +4 at the label, -2 elsewhere."""
    tl = np.full((y.shape[0], num_classes), -2.0, np.float32)
    tl[np.arange(y.shape[0]), y] = 4.0
    return tl


def gcn_kd_config(shape: str):
    from efficient_gnns_tpu_torch.train.config import DistillConfig

    return DistillConfig(training="kd", **SHAPES[shape]["gcn"])


def sign_inputs(shape: str):
    """The SIGN step's hop features and labels, whole (NumPy, as the JAX
    dryrun draws them)."""
    cfg = SHAPES[shape]
    sc = cfg["sign"]
    rng = np.random.default_rng(SIGN_DATA_SEED)
    feats = [rng.normal(size=(sc["batch"], cfg["feat_dim"])).astype(np.float32)
             for _ in range(sc["hops"])]
    return feats, rng.integers(0, cfg["num_classes"], size=sc["batch"]).astype(np.int64)


def sign_model(shape: str, device):
    from efficient_gnns_tpu_torch.models import SIGN

    cfg = SHAPES[shape]
    sc = cfg["sign"]
    return SIGN(cfg["feat_dim"], sc["hidden"], cfg["num_classes"], sc["hops"],
                ff_layers=SIGN_FF_LAYERS, dropout=sc["dropout"], seed=0, device=device)


def _nll_sum(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, -1)
    return -(logp.gather(1, y[:, None])[:, 0] * mask).sum()


def single_device_gcn_kd(inputs: Dict, device) -> List[float]:
    """The GCN-KD section's losses on one device: ``NodeDistillTrainer`` on
    the whole graph, ``reps`` steps."""
    from efficient_gnns_tpu_torch.models import GCN
    from efficient_gnns_tpu_torch.train.node_trainer import NodeDistillTrainer

    cfg = gcn_kd_config(inputs["shape"])
    model = GCN(inputs["x"].shape[1], cfg.hidden, inputs["num_classes"], cfg.num_layers,
                cfg.dropout, seed=0, device=device)
    tr = NodeDistillTrainer(model, cfg, inputs["graph"], inputs["x"], inputs["y"],
                            inputs["split_idx"],
                            teacher_logits=teacher_logits(inputs["y"], inputs["num_classes"]),
                            seed=0, device=device)
    return [tr.train_epoch(e)["loss"] for e in range(SHAPES[inputs["shape"]]["reps"])]


def single_device_sign(shape: str, device) -> List[float]:
    """The SIGN section's losses on one device: ``SIGN.forward``, the NLL
    mean, Adam, ``reps`` steps."""
    device = torch.device(device)
    model = sign_model(shape, device)
    opt = torch.optim.Adam(model.parameters(), lr=SIGN_LR)
    feats, labels = sign_inputs(shape)
    feats = [torch.from_numpy(f).to(device) for f in feats]
    labels = torch.from_numpy(labels).to(device)
    gen = torch.Generator(device=device)
    losses = []
    for _ in range(SHAPES[shape]["reps"]):
        gen.manual_seed(SIGN_DROPOUT_SEED)
        model.train()
        logits, _ = model(feats, gen)
        loss = F.nll_loss(F.log_softmax(logits, -1), labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def _digest(tensors: Dict[str, torch.Tensor]) -> str:
    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def single_device_loss(inputs: Dict, device) -> float:
    """The halo step's loss on one device: ``ops.spmm`` over the whole
    graph."""
    from efficient_gnns_tpu_torch.ops import spmm

    g = inputs["graph"].to(device)
    x = torch.from_numpy(inputs["x"]).to(device)
    z = x @ torch.from_numpy(inputs["w"]).to(device)
    mask = torch.from_numpy(inputs["node_mask"]).to(device).float()
    y = torch.from_numpy(inputs["y"]).to(device)
    return float(_nll_sum(spmm(g, z), y, mask)) / inputs["n_real"]


class _Clock:
    """Per-section host ms of each of ``reps`` runs (the ranks start each
    together; synchronised on a card), K1's launches in one run and the
    bytes this rank's collectives send in one run (``sent``,
    :func:`_collectives`); the first run's result. With ``exchange``, the
    last run's collectives are timed inside it as well: ``exchange_ms``
    holds their sum, and the run's own ms counts the synchronisations."""

    def __init__(self, device, reps):
        from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum

        self.device, self.reps, self.k1 = device, reps, csr_segment_sum
        self.ms, self.launches, self.exchange_ms, self.sent = {}, {}, {}, {}

    def __call__(self, name, fn, reps=None, exchange=False):
        reps = self.reps if reps is None else reps
        self.ms[name], before, results, sent = [], self.k1.launches, [], 0
        for i in range(reps):
            _sync(self.device)
            dist.barrier()  # every rank starts the section together
            timed = exchange and i == reps - 1
            with _collectives(self.device, timed) as seen:
                t0 = time.perf_counter()
                results.append(fn())
                _sync(self.device)
                self.ms[name].append((time.perf_counter() - t0) * 1e3)
            sent += seen["bytes"]
            if timed:
                self.exchange_ms[name] = sum(seen["ms"])
        self.launches[name] = (self.k1.launches - before) // reps
        self.sent[name] = sent // reps
        return results[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _payload(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _all_to_all_sent(out, inp, out_splits=None, in_splits=None, group=None, **_) -> int:
    rows, me = inp.shape[0], dist.get_rank(group)
    own = rows // dist.get_world_size(group) if in_splits is None else in_splits[me]
    return _payload(inp) * (rows - own) // max(rows, 1)


@contextlib.contextmanager
def _collectives(device, timed=False):
    """Within: every all-gather, reduce-scatter, all-reduce and all-to-all
    of the ranks (the entry points of ``parallel.collectives`` and of
    ``torch.distributed`` that they call) counted in ``"bytes"``, what this
    rank sends: an all-reduce's buffer, an all-gather's block, a
    reduce-scatter's or an all-to-all's input less the rank's own block.
    With ``timed`` each one's host ms is appended to ``"ms"``, the device
    synchronised before and after it (so the device work it waits on is
    not counted). Yields that dict."""
    from efficient_gnns_tpu_torch.parallel import collectives

    seen = {"bytes": 0, "ms": []}

    def counted(fn, sent):
        def call(*args, **kwargs):
            seen["bytes"] += sent(*args, **kwargs)
            if not timed:
                return fn(*args, **kwargs)
            _sync(device)
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            _sync(device)
            seen["ms"].append((time.perf_counter() - t0) * 1e3)
            return result
        return call

    names = ((collectives, "_all_gather", lambda out, x, **_: _payload(x)),
             (collectives, "_reduce_scatter", lambda out, x, **_: _payload(x) - _payload(out)),
             (dist, "all_reduce", lambda t, *_, **__: _payload(t)),
             (dist, "all_to_all_single", _all_to_all_sent))
    saved = [getattr(m, n) for m, n, _ in names]
    for (m, n, sent), fn in zip(names, saved):
        setattr(m, n, counted(fn, sent))
    try:
        yield seen
    finally:
        for (m, n, _), fn in zip(names, saved):
            setattr(m, n, fn)


def _halo_step(spmm_fn, x, y, mask, w0, n_real, group):
    """One SGD step of the halo GCN whose aggregation is ``spmm_fn`` over
    the ranks of ``group``; returns (loss, the next w)."""
    from efficient_gnns_tpu_torch.parallel.collectives import all_reduce_replicated

    w = w0.clone().requires_grad_()
    h = spmm_fn(x @ w)
    loss = all_reduce_replicated(_nll_sum(h, y, mask), group) / n_real
    loss.backward()
    grad = w.grad.clone()
    dist.all_reduce(grad, group=group)  # w is replicated: sum the ranks' shares
    return float(loss.detach()), (w0 - 0.1 * grad).cpu().numpy()


def _gcn_kd_section(clock, mesh, inputs, out):
    """The data-parallel GCN-KD train steps and an evaluation."""
    from efficient_gnns_tpu_torch.parallel.sharded_trainer import ShardedNodeDistillTrainer

    cfg = SHAPES[inputs["shape"]]
    tr = ShardedNodeDistillTrainer(
        mesh, gcn_kd_config(inputs["shape"]), inputs["halo_dp"], inputs["x"], inputs["y"],
        inputs["split_idx"], inputs["num_classes"], node_mask=inputs["node_mask"],
        teacher_logits=teacher_logits(inputs["y"], inputs["num_classes"]), seed=0)
    losses = out["gcn_kd_losses"] = []
    clock("gcn_kd_step", lambda: losses.append(tr.train_epoch(len(losses))["loss"]))
    out["gcn_kd_accs"] = clock("gcn_kd_eval", lambda: tr.evaluate()[1])
    out["gcn_kd_digest"] = _digest(tr.model.state_dict())
    # the halo exchanges of a train step: forward and backward at the
    # hidden and the class widths, each way
    widths = cfg["gcn"]["hidden"] * (cfg["gcn"]["num_layers"] - 1) + cfg["num_classes"]
    out["gcn_kd_exchange_bytes"] = 2 * tr.graph.local.exchange_rows * widths * 4


def _sign_section(clock, mesh, inputs, out):
    """The SIGN dp x tp steps, each with the dropout key of the first."""
    from efficient_gnns_tpu_torch.parallel.mesh import shard_rows
    from efficient_gnns_tpu_torch.parallel.tensor import shard_sign, sign_dp_tp_step

    model = shard_sign(sign_model(inputs["shape"], mesh.device), mesh)
    opt = torch.optim.Adam(model.parameters(), lr=SIGN_LR)
    feats, labels = sign_inputs(inputs["shape"])
    feats = [shard_rows(mesh, torch.from_numpy(f)) for f in feats]
    labels = shard_rows(mesh, torch.from_numpy(labels))
    gen = torch.Generator(device=mesh.device)

    def step():
        gen.manual_seed(SIGN_DROPOUT_SEED)
        return float(sign_dp_tp_step(model, opt, feats, labels, mesh, gen))

    losses = out["sign_losses"] = []
    clock("sign_step", lambda: losses.append(step()), exchange=True)
    params = dict(model.named_parameters())
    out["sign_digest"] = dict(
        replicated=_digest({n: p for n, p in params.items() if n not in model.tp_split}),
        split=(mesh.index("model"), _digest({n: params[n] for n in model.tp_split})))
    # the column gathers of a step: each split layer's output, less this
    # rank's own block, received (and as much reduce-scattered back)
    m, rows = mesh.size("model"), labels.shape[0]
    widths = [params[n].shape[1] * m for n in sorted(model.tp_split)]
    out["sign_gather_bytes"] = sum(rows * w * (m - 1) // m * 4 for w in widths)


def _sin_fwd_bwd(mesh, fn, local, x):
    x = x.clone().requires_grad_()
    out = fn(mesh, local, x)
    torch.sin(out).sum().backward()
    return out.detach(), x.grad


def dryrun_rank(device: torch.device, inputs: Dict) -> Dict:
    """One rank of :func:`dryrun_multichip`; returns its losses, its
    per-section host ms and K1 launches, and its exchange's bytes."""
    from efficient_gnns_tpu_torch.data.mag import synthetic_mag_dataset
    from efficient_gnns_tpu_torch.parallel.collectives import all_to_all
    from efficient_gnns_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from efficient_gnns_tpu_torch.parallel.partition import (
        local_partition,
        spmm_halo,
        spmm_halo_2level,
        spmm_sharded,
    )
    from efficient_gnns_tpu_torch.parallel.ring import ring_nce_term
    from efficient_gnns_tpu_torch.train.config import DistillConfig
    from efficient_gnns_tpu_torch.train.mag_trainer import MagTrainer

    cfg = SHAPES[inputs["shape"]]
    d = dist.get_world_size()
    out = {"rank": dist.get_rank()}
    clock = _Clock(device, cfg["reps"])
    mesh = make_mesh(d, device=device)
    axes, shape = dp_mesh_shape(d)
    mesh_dp = make_mesh(d, axes=axes, shape=shape, device=device)
    _gcn_kd_section(clock, mesh_dp, inputs, out)
    if "model" in axes:
        _sign_section(clock, mesh_dp, inputs, out)
    else:
        out["sign_losses"] = None
        print(f"dryrun: an odd world of {d}: the SIGN dp x tp ({d}/2, 2) section is skipped",
              flush=True)
    halo = local_partition(mesh, inputs["halo"])
    allg = local_partition(mesh, inputs["allg"])

    def rows(a):
        return shard_rows(mesh, torch.from_numpy(a))

    x, y, mask = rows(inputs["x"]), rows(inputs["y"]), rows(inputs["node_mask"]).float()
    w0 = torch.from_numpy(inputs["w"]).to(device)
    n_real = inputs["n_real"]

    out["halo_loss"], out["w_next"] = clock("halo_step", lambda: _halo_step(
        lambda z: spmm_halo(mesh, halo, z), x, y, mask, w0, n_real, mesh.group("data")))
    out["exchange_bytes"] = halo.exchange_rows * cfg["num_classes"] * 4
    # the step's exchange alone: its share of the step
    blocks = torch.zeros(d * halo.halo_width, cfg["num_classes"], device=device)
    clock("halo_exchange", lambda: all_to_all(blocks, mesh.group("data")))

    xf = torch.from_numpy(np.random.default_rng(4).normal(
        size=(halo.rows_per_dev * d, cfg["spmm_feat"])).astype(np.float32))
    xs = shard_rows(mesh, xf)
    for name, fn, local in (("spmm_sharded", spmm_sharded, allg), ("spmm_halo", spmm_halo, halo)):
        o, g = clock(name, lambda: _sin_fwd_bwd(mesh, fn, local, xs))
        out[name] = (float(o.abs().sum()), float(g.abs().sum()))  # checked finite

    rng = np.random.default_rng(2)
    nce_rows = cfg["nce_rows"] - cfg["nce_rows"] % d  # equal shards on every rank
    ft, tt = (rng.normal(size=(nce_rows, cfg["nce_dim"])).astype(np.float32)
              for _ in range(2))
    fs = shard_rows(mesh, torch.from_numpy(ft)).requires_grad_()

    def nce():
        v = ring_nce_term(mesh, fs, shard_rows(mesh, torch.from_numpy(tt)), nce_T=0.075)
        v.backward()
        return float(v.detach())

    out["nce"] = clock("ring_nce", nce)

    if d % 2:
        out["halo2_loss"] = None
        print(f"dryrun: an odd world of {d}: the two-level (2, {d}/2) section is skipped",
              flush=True)
    else:
        mesh2 = make_mesh(d, axes=("host", "chip"), shape=(2, d // 2), device=device)
        halo2 = local_partition(mesh2, inputs["halo"], ("host", "chip"))
        out["halo2_loss"], w2 = clock("halo2_step", lambda: _halo_step(
            lambda z: spmm_halo_2level(mesh2, halo2, z), x, y, mask, w0, n_real,
            dist.group.WORLD))
        out["halo2_same_bits"] = (out["halo2_loss"] == out["halo_loss"]
                                  and np.array_equal(w2, out["w_next"]))

    mds = synthetic_mag_dataset(**cfg["mag"])
    mtr = MagTrainer(DistillConfig(training="supervised", hidden=cfg["mag_hidden"],
                                   num_layers=cfg["mag_layers"], dropout=0.0, lr=0.01),
                     mds, batch_size=cfg["mag_batch"], num_steps=cfg["mag_steps"], seed=0,
                     prefetch=0, device=device)
    mtr.shard_embeddings(mesh)
    out["mag_loss"] = clock("mag_epoch", lambda: mtr.train_epoch(0)["loss"], reps=1)
    out["ms"], out["k1_launches"] = clock.ms, clock.launches
    out["exchange_ms"] = clock.exchange_ms
    return out


def dryrun_multichip(n_devices: int, *, backend: str = "nccl", device: str = "cuda",
                     shape: str = "tiny") -> Dict:
    """:func:`build_inputs`, then :func:`run_dryrun` on a world of
    ``n_devices`` ranks."""
    return run_dryrun(build_inputs(n_devices, shape), n_devices, backend=backend,
                      device=device)


def run_dryrun(inputs: Dict, n_devices: int, *, backend: str = "nccl",
               device: str = "cuda") -> Dict:
    """Run :func:`dryrun_rank` on a world of ``n_devices`` ranks; check that
    every loss is finite, that the GCN-KD, SIGN and halo steps' losses equal
    the single-device ones (rtol 1e-5), that the ranks agree and that the
    replicated parameters hold the same bits on every rank; print one
    summary line and return rank 0's result (with every rank's under
    ``"ranks"``, the single-device losses and the halo partition's
    ``halo_stats``)."""
    from efficient_gnns_tpu_torch.native import host
    from efficient_gnns_tpu_torch.parallel.partition import halo_stats

    host.available()  # build the native walker here, not in every rank at once
    shared = {k: v for k, v in inputs.items() if k not in ("graph", "edges")}  # the ranks' share
    ranks = run_world(dryrun_rank, n_devices, backend=backend, device=device,
                      args=(shared,))
    r0 = dict(ranks[0], ranks=ranks, halo_stats=halo_stats(inputs["halo"]))
    single = single_device_loss(inputs, device)
    single_gcn = single_device_gcn_kd(inputs, device)
    single_sign = None if r0["sign_losses"] is None else single_device_sign(inputs["shape"],
                                                                            device)
    losses = [r0["halo_loss"], r0["nce"], r0["mag_loss"], *r0["spmm_sharded"],
              *r0["spmm_halo"], *r0["gcn_kd_losses"], *(r0["sign_losses"] or [])]
    if not all(np.isfinite(v) for v in losses):
        raise RuntimeError(f"dryrun: a loss or an SpMM's sum is not finite: {losses}")
    for name, got, want in (("halo step", [r0["halo_loss"]], [single]),
                            ("GCN-KD dp step", r0["gcn_kd_losses"], single_gcn),
                            ("SIGN dp x tp step", r0["sign_losses"], single_sign)):
        if want is not None and not np.allclose(got, want, rtol=1e-5, atol=0.0):
            raise RuntimeError(f"dryrun: {name} losses {got} != single-device {want}")
    for key in ("halo_loss", "nce", "mag_loss", "halo2_loss", "gcn_kd_losses", "gcn_kd_accs",
                "sign_losses", "gcn_kd_digest"):
        if any(r[key] != r0[key] for r in ranks):
            raise RuntimeError(f"dryrun: the ranks disagree on {key}")
    if r0["sign_losses"] is not None:
        split = {}
        for r in ranks:
            i, dig = r["sign_digest"]["split"]
            if (r["sign_digest"]["replicated"] != r0["sign_digest"]["replicated"]
                    or split.setdefault(i, dig) != dig):
                raise RuntimeError("dryrun: the SIGN ranks' replicated parameters differ")
    if n_devices % 2 == 0 and not all(r["halo2_same_bits"] for r in ranks):
        raise RuntimeError("dryrun: the two-level step is not the flat step's bits")
    r0.update(single_device_loss=single, single_gcn_kd_losses=single_gcn,
              single_sign_losses=single_sign)
    two = ("skipped (odd world)" if r0["halo2_loss"] is None
           else f"{r0['halo2_loss']:.6f} (the flat step's bits)")
    sign = ("skipped (odd world)" if single_sign is None
            else f"{r0['sign_losses'][0]:.6f} (single device {single_sign[0]:.6f})")
    print(f"dryrun_multichip OK on {n_devices} ranks ({backend}, {device}, "
          f"{inputs['shape']}): {r0['halo_stats']}, "
          f"GCN-KD dp step loss {r0['gcn_kd_losses'][0]:.6f} (single device "
          f"{single_gcn[0]:.6f}), SIGN dp x tp step loss {sign}, "
          f"halo-partition GCN step loss {r0['halo_loss']:.6f} (single device {single:.6f}), "
          f"2-level (host x chip) halo step loss {two}, ring NCE {r0['nce']:.4f}, "
          f"MAG sharded-emb step loss {r0['mag_loss']:.4f}", flush=True)
    return r0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n_devices", type=int, nargs="?", default=4)
    parser.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--shape", default="tiny", choices=tuple(SHAPES))
    a = parser.parse_args(argv)
    r = dryrun_multichip(a.n_devices, backend=a.backend, device=a.device, shape=a.shape)
    for rank in r["ranks"]:
        print(f"rank {rank['rank']}: ms {rank['ms']} K1 launches {rank['k1_launches']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
