"""The work of an epoch, counted from a configuration's shapes, and the
card's peaks.

FLOPs are ``2 m n k`` for every matrix product the algorithm needs, forward
and backward (no input gradient where the input is data), plus ``2 E F``
for each SpMM. Elementwise work is not counted. An SpMM's least time is the
larger of its bytes over the memory bandwidth and its FLOPs over the
float32 peak, its bytes each input byte read once and each output byte
written once: the messages in their dtype, the senders and row offsets
(int32), the edge weights where there are some (float32), and the float32
output. Widths are the useful ones (a hub layer's ``H (D + 1)``), not the
program's padded layout.
"""

from __future__ import annotations

from typing import Dict, List

# NVIDIA H100 SXM data sheet: dense float32 outside the tensor cores, HBM3
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
GIB = 2.0**30


def matmul(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def spmm_flops(e: int, f: int) -> float:
    return 2.0 * e * f


def spmm_bytes(n: int, e: int, f: int, msg_bytes: int, weighted: bool) -> float:
    return n * f * msg_bytes + e * 4 + (n + 1) * 4 + (e * 4 if weighted else 0) + n * f * 4


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


class Epoch:
    """Accumulates an epoch's matmul FLOPs and its SpMMs."""

    def __init__(self):
        self.matmul_flops = 0.0
        self.spmms: List[tuple] = []  # (n, e, f, msg_bytes, weighted)

    def mm(self, m, k, n, times: int = 1):
        self.matmul_flops += times * matmul(m, k, n)

    def spmm(self, n, e, f, msg_bytes, weighted):
        self.spmms.append((n, e, f, msg_bytes, weighted))

    def summary(self) -> Dict[str, float]:
        sp_flops = sum(spmm_flops(e, f) for _, e, f, _, _ in self.spmms)
        least = sum(least_seconds(spmm_flops(e, f), spmm_bytes(n, e, f, b, w))
                    for n, e, f, b, w in self.spmms)
        return {"flops": self.matmul_flops + sp_flops, "spmm_calls": len(self.spmms),
                "spmm_flops": sp_flops, "spmm_least_s": least}


def gcn_epoch(n: int, e: int, dims: List[int], n_train: int, traffic: dict,
              teacher_dim: int) -> Dict[str, float]:
    """A GCN student epoch: a train step (``dims`` = input, hidden..., classes;
    each layer ``spmm(X W)``, float32 messages, static norm weights), then an
    evaluation forward; in ``nce`` the two projection heads on the train rows
    and the ``M x M`` InfoNCE."""
    ep = Epoch()
    for forward_only in (False, True):  # the train step, then the evaluation
        for i in range(len(dims) - 1):
            a, b = dims[i], dims[i + 1]
            ep.mm(n, a, b)
            ep.spmm(n, e, b, 4, True)
            if not forward_only:
                ep.spmm(n, e, b, 4, True)  # the transposed SpMM of the backward
                ep.mm(n, a, b, times=2 if i > 0 else 1)  # dW, and dX past the input
    if traffic["training"] == "nce":
        p, m, hid = traffic["proj_dim"], traffic["max_samples"], dims[-2]
        ep.mm(n_train, hid, p, times=3)  # student head: forward, dW, dX
        ep.mm(n_train, teacher_dim, p, times=2)  # teacher head: forward, dW
        ep.mm(m, p, m, times=3)  # similarities: forward and both operands' gradients
    return ep.summary()


def gat_hub_epoch(n: int, e: int, in_dim: int, cfg: dict) -> Dict[str, float]:
    """A GAT teacher epoch on the hub path: a train step of ``n_label_iters +
    1`` forwards (edge-dropped, weighted SpMMs) and the last one's backward,
    then an evaluation of as many forwards (unweighted). A layer is the
    ``fc`` and residual products, the sender logits and one SpMM of
    ``[z x | z]`` (``H (D + 1)`` wide) in the hub message dtype."""
    heads, width, layers = cfg["n_heads"], cfg["n_hidden"], cfg["n_layers"]
    msg = {"bfloat16": 2, "float32": 4}[cfg["hub_message_dtype"]]
    shapes = []
    for i in range(layers):
        last = i == layers - 1
        h, d = (1, cfg["num_classes"]) if last else (heads, width)
        shapes.append((in_dim if i == 0 else heads * width, h, d))
    passes = cfg["n_label_iters"] + 1
    ep = Epoch()
    for weighted, backward in ((True, True), (False, False)):
        for _ in range(passes):
            for d_in, h, d in shapes:
                ep.mm(n, d_in, h * d, times=2)
                ep.mm(n * h, d, 1)
                ep.spmm(n, e, h * (d + 1), msg, weighted)
        if backward:
            for i, (d_in, h, d) in enumerate(shapes):
                ep.spmm(n, e, h * (d + 1), msg, weighted)
                ep.mm(n, d_in, h * d, times=4 if i > 0 else 2)
                ep.mm(n * h, d, 1, times=2)
    return ep.summary()
