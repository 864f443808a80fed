"""Micro-benchmarks of the port on the card (counterpart of
``efficient_gnns_tpu/analysis/microbench.py``).

* ``gat-step``: the GAT teacher's train or eval step at arxiv shape
  (3 layers of 3 heads x 250, the flags of ``experiments/arxiv_hard.sh``).
  With ``--hub 0`` the graph has no hub partition and every layer runs
  ``gat_attention`` (K2, K4-K7); ``--msg-dtype bfloat16`` makes K2 and K4
  read bfloat16 messages (and the hub path's K1, where there is one).
* ``spmm``: ``sum(spmm(graph, x) ** 2)`` forward and backward (K1 twice),
  with its bound on the H100 SXM's memory rate and the card's name.

:func:`bench_chain` times chained iterations the way the JAX ``bench_scan``
does (a carry threaded through every iteration, two warm-ups, one timed run
ended by a host read of a scalar); :func:`cached_graph` keeps a built
dataset under ``logs/cache/`` with ``torch.save``.

    python -m efficient_gnns_tpu_torch.analysis.microbench gat-step --hub 0 \\
        --msg-dtype bfloat16 --which train --trace
    python -m efficient_gnns_tpu_torch.analysis.microbench spmm --feat-dim 128
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import torch

from efficient_gnns_tpu_torch.analysis.timing import capture_trace, summarize_trace
from efficient_gnns_tpu_torch.data import synthetic_node_dataset
from efficient_gnns_tpu_torch.ops import dispatch, spmm
from efficient_gnns_tpu_torch.train.gat_teacher import GATTeacherTrainer, TeacherConfig

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM device memory (data sheet)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CACHE_DIR = os.path.join(_ROOT, "logs", "cache")
TRACE_DIR = os.path.join(_ROOT, "logs", "traces")
MSG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cached_graph(key: str, build: Callable[[], object]):
    """Build-or-load an object (a dataset with its graph) kept under
    ``logs/cache/<key>.pt``; the file is one this function wrote."""
    path = os.path.join(_CACHE_DIR, f"{key}.pt")
    if os.path.exists(path):
        return torch.load(path, weights_only=False)
    obj = build()
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return obj


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [x for v in tree for x in _leaves(v)]


def _add(tree, nonce: float):
    if isinstance(tree, torch.Tensor):
        return tree + nonce if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _add(v, nonce) for k, v in tree.items()}
    return type(tree)(_add(v, nonce) for v in tree)


def bench_chain(fn, init, iters: int = 30, label: str = "", verbose: bool = True,
                const=None, has_aux: bool = False) -> float:
    """ms per iteration of ``iters`` chained applications of ``fn`` (the
    counterpart of the JAX ``bench_scan``). ``fn`` maps carry -> new carry
    (``fn(const, carry)`` with ``const``), or, with ``has_aux``, carry ->
    ``(new carry, aux)``; the carry (a tensor or a tuple, list or dict of
    them) must thread through the work. Two warm-ups, then one timed run
    from a fresh nonce added to the floating carry, ended by a host read of
    the sum of the final carry."""

    def run(nonce):
        carry = _add(init, nonce)
        for _ in range(iters):
            out = fn(carry) if const is None else fn(const, carry)
            carry = out[0] if has_aux else out
        return sum(a.float().sum() for a in _leaves(carry))

    float(run(0.0))
    float(run(1e-13))
    t0 = time.perf_counter()
    float(run(1e-12))
    dt = (time.perf_counter() - t0) / iters * 1e3
    if verbose and label:
        print(f"{label}: {dt:.3f} ms", flush=True)
    return dt


def set_message_dtype(name: Optional[str]) -> None:
    """``--msg-dtype``: both message dtypes (K2/K4's and the hub path's)."""
    if name:
        dispatch.set_message_dtype(MSG_DTYPES[name])
        dispatch.set_hub_message_dtype(MSG_DTYPES[name])


def gat_dataset(num_nodes: int = 169_343, num_edges: int = 1_166_243, hub="auto"):
    """The teacher's arxiv-shaped graph as the JAX microbench builds it
    (seed 42, unweighted, no label smoothing); ``hub`` 0 leaves out the hub
    partition."""
    return synthetic_node_dataset(num_nodes=num_nodes, num_edges=num_edges, seed=42,
                                  hub_dense=hub, gcn_norm=False, label_smoothing_hops=0)


def teacher_trainer(ds, device="cuda", config: Optional[TeacherConfig] = None):
    """The flagship teacher's trainer on ``ds`` (``experiments/arxiv_hard.sh``
    step 1: label reuse, one label iteration, no attn-dst, symmetric norm,
    edge-drop 0.3, input-drop 0.25), from seed 0; ``config`` replaces the
    flags."""
    cfg = config or TeacherConfig(n_label_iters=1, use_labels=True, edge_drop=0.3,
                                  input_drop=0.25, no_attn_dst=True, use_norm=True)
    return GATTeacherTrainer(cfg, ds.graph, ds.x, ds.y, ds.split_idx, ds.num_classes,
                             seed=0, device=device)


def gat_step(trainer: GATTeacherTrainer, which: str = "train", iters: int = 5,
             repeats: int = 3, trace_dir: Optional[str] = None) -> Dict[str, object]:
    """Time ``trainer``'s train step (one RMSprop update, step ``i`` seeding
    its draws) or its full-graph eval step: one first call, then ``repeats``
    times ``iters`` calls ended by a host read. Returns ``first_loss`` (the
    train step's loss, or the eval step's train-split loss, of the first
    call), ``step_ms`` (one mean a repeat) and, with ``trace_dir``, the
    device time by kernel of two profiled steps (``trace``)."""
    if which == "train":
        def run(i):
            return trainer._train_step(i)[0]
    elif which == "eval":
        def run(i):
            return trainer._eval_step()[3][0]
    else:
        raise ValueError(f"gat_step: which is train or eval, not {which!r}")
    t0 = time.time()
    first = float(run(0))
    print(f"{which} step first call {time.time() - t0:.1f}s (loss {first:.6f})", flush=True)
    step_ms = []
    for _ in range(repeats):
        t0 = time.time()
        for i in range(iters):
            sync = run(i)
        float(sync)
        step_ms.append((time.time() - t0) / iters * 1e3)
        print(f"{which} step: {step_ms[-1]:.1f} ms", flush=True)
    out = {"first_loss": first, "step_ms": step_ms}
    if trace_dir is not None:
        capture_trace(run, 0, trace_dir=trace_dir, steps=2, device=trainer.device)
        out["trace"] = summarize_trace(trace_dir)
    return out


def _gat_step_main(args) -> None:
    set_message_dtype(args.msg_dtype)
    device = torch.device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    else:
        print(f"device: {device}", flush=True)
    t0 = time.time()
    hub = "auto" if args.hub == "auto" else int(args.hub)
    build = lambda: gat_dataset(args.num_nodes, args.num_edges, hub)  # noqa: E731
    key = f"arxiv_gat_hub_{args.hub}_{args.num_nodes}_{args.num_edges}"
    ds = cached_graph(key, build) if args.cache else build()
    print(f"graph built in {time.time() - t0:.1f}s "
          f"(hub={'on' if ds.graph.hub is not None else 'off'})", flush=True)
    trainer = teacher_trainer(ds, device)
    print(f"params {trainer.num_params()}", flush=True)
    trace_dir = os.path.join(TRACE_DIR, f"gat_step_{args.which}") if args.trace else None
    gat_step(trainer, args.which, args.iters, trace_dir=trace_dir)


def spmm_step(graph, x: torch.Tensor) -> torch.Tensor:
    """``x + 1e-12 * d/dx sum(spmm(graph, x) ** 2)``: one SpMM forward and
    its backward, the carry of :func:`bench_chain`."""
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad((spmm(graph, x) ** 2).sum(), x)
    return (x + 1e-12 * g).detach()


def spmm_bench(graph, x: torch.Tensor, iters: int = 20) -> Dict[str, float]:
    """``spmm_step`` chained ``iters`` times on ``graph`` (on ``x``'s device):
    ms a step beside its least time on the H100 SXM, where each of its two
    K1 calls reads ``x`` (or the cotangent), the CSR's indices and weights
    once and writes its ``[N, F]`` float32 output once, at 3.35 TB/s."""
    dt = bench_chain(spmm_step, x, iters=iters, verbose=False, const=graph)
    n, e = graph.num_nodes, graph.n_edge
    one_call = 2 * n * x.shape[1] * 4 + e * (4 + 4) + (n + 1) * 4
    return {"ms": dt, "bound_ms": 2 * one_call / HBM_BYTES_PER_S * 1e3}


def _spmm_main(args) -> None:
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    print(f"device: {name}", flush=True)
    t0 = time.time()
    ds = synthetic_node_dataset(num_nodes=args.num_nodes, num_edges=args.num_edges,
                                feat_dim=args.feat_dim, seed=0, label_smoothing_hops=0)
    graph = ds.graph.to(device)
    x = torch.as_tensor(ds.x, device=device)
    print(f"graph built in {time.time() - t0:.1f}s", flush=True)
    r = spmm_bench(graph, x)
    print(f"SpMM fwd+bwd: {r['ms']:.3f} ms on {name} ({r['bound_ms'] / r['ms']:.3f}x of "
          f"the {r['bound_ms']:.4f} ms bound at the H100 SXM's "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)", flush=True)
    if args.trace:
        trace_dir = capture_trace(spmm_step, graph, x, steps=2, device=device,
                                  trace_dir=os.path.join(TRACE_DIR, "spmm"))
        summarize_trace(trace_dir)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("efficient_gnns_tpu_torch microbench")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("spmm", help="SpMM fwd+bwd + kernel attribution")
    s.add_argument("--num-nodes", type=int, default=169_343)
    s.add_argument("--num-edges", type=int, default=1_166_243)
    s.add_argument("--feat-dim", type=int, default=128)
    s.add_argument("--trace", action="store_true")
    s.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    g = sub.add_parser("gat-step", help="GAT teacher step time at arxiv shape")
    g.add_argument("--which", choices=["train", "eval"], default="train")
    g.add_argument("--num-nodes", type=int, default=169_343)
    g.add_argument("--num-edges", type=int, default=1_166_243)
    g.add_argument("--hub", default="auto")
    g.add_argument("--iters", type=int, default=5)
    g.add_argument("--msg-dtype", default=None, choices=sorted(MSG_DTYPES),
                   help="override message dtypes (float32|bfloat16)")
    g.add_argument("--trace", action="store_true",
                   help="capture + summarize a torch.profiler trace")
    g.add_argument("--cache", action="store_true",
                   help="cache the built graph under logs/cache")
    g.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)
    if args.cmd == "gat-step":
        _gat_step_main(args)
    elif args.cmd == "spmm":
        _spmm_main(args)


if __name__ == "__main__":
    main()
