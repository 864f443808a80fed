"""Layer-wise (chunked) R-GCN inference over the full graph (counterpart of
``efficient_gnns_tpu/train/layerwise.py``).

The reference evaluates ogbn-mag layer by layer over the full graph
(``RGCN.inference``, ``mag_pyg/gnn.py:140-171``), so that memory holds one
layer's activations and not the unrolled forward. Here, as in the JAX
package:

* the receivers are cut into chunks of ``chunk_nodes`` nodes, and the edges
  are sorted once on the host by (chunk, relation, local receiver);
* inside a chunk, each relation's mean is ONE aggregation over the typed
  segment ids ``relation * C + local receiver`` with the static weights
  ``1/deg_type[receiver]``, followed by one batched product with the stacked
  relation kernels ``[R, F_in, F_out]``: aggregate, then project;
* the per-node-type root linears and the embedding injection are those of
  ``models/gnns.py::RGCN`` (the same parameters).

The JAX package sums a chunk with XLA's ``segment_sum``, not a Pallas
kernel. The port's choice is K1 (``ops/cuda/segment_sum.py::
csr_segment_sum``): a chunk's sorted segment ids are already a CSR over its
``R * C`` rows, so each chunk carries its senders, weights, ``row_offsets``
and row split, uploaded once at construction. On CUDA ``index_add_`` adds
with float atomics; K1 keeps the port's rule of one owner per output row.
Each chunk of each layer is one K1 launch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from efficient_gnns_tpu_torch.graphs.row_split import RowSplit, build_row_split, record_pair
from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum


class RGCNLayerwiseInference:
    """Chunked full-graph inference of an ``RGCN``.

    Args:
      senders, receivers, edge_type: host int arrays of the full typed graph
        (COO, any order).
      num_nodes: node count N (features are ``[N, F]``).
      num_edge_types: relation count R.
      chunk_nodes: receivers per chunk C.
      device: where the chunks' arrays live (and the inference runs).
    """

    def __init__(self, senders: np.ndarray, receivers: np.ndarray, edge_type: np.ndarray,
                 num_nodes: int, num_edge_types: int, chunk_nodes: int = 16384,
                 device="cuda"):
        s = np.asarray(senders, np.int64)
        r = np.asarray(receivers, np.int64)
        et = np.asarray(edge_type, np.int64)
        self.num_nodes, self.num_edge_types = int(num_nodes), int(num_edge_types)
        c = self.chunk_nodes = int(chunk_nodes)
        self.n_chunks = -(-self.num_nodes // c)

        # per-(relation, receiver) in-degree -> the mean as static weights
        cell = et * self.num_nodes + r
        deg = np.bincount(cell, minlength=self.num_edge_types * self.num_nodes)
        w = (1.0 / np.maximum(deg[cell], 1)).astype(np.float32)

        # edges by (chunk, relation, local receiver): chunks contiguous, the
        # typed segment ids sorted inside each chunk (the JAX order)
        chunk_of = r // c
        seg_local = et * c + (r % c)
        order = np.lexsort((seg_local, chunk_of))
        s, w, seg_local, chunk_of = s[order], w[order], seg_local[order], chunk_of[order]
        starts = np.zeros(self.n_chunks + 1, np.int64)
        np.cumsum(np.bincount(chunk_of, minlength=self.n_chunks), out=starts[1:])

        rows = self.num_edge_types * c
        self.chunks: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, RowSplit]] = []
        for i in range(self.n_chunks):
            lo, hi = starts[i], starts[i + 1]
            offsets = np.zeros(rows + 1, np.int32)
            np.cumsum(np.bincount(seg_local[lo:hi], minlength=rows), out=offsets[1:])
            split = build_row_split(offsets).to(device)
            row_offsets = torch.from_numpy(offsets).to(device)
            record_pair(split, row_offsets)
            self.chunks.append((
                torch.from_numpy(s[lo:hi].astype(np.int32)).to(device),
                torch.from_numpy(w[lo:hi]).to(device), row_offsets, split))

    def _layer(self, h: torch.Tensor, rel_kernels: torch.Tensor) -> torch.Tensor:
        """``out[i] = sum_r mean_{j -r-> i}(h_j) @ W_r`` for every node,
        chunk by chunk; ``rel_kernels`` is ``[R, F_in, F_out]``."""
        c, nr = self.chunk_nodes, self.num_edge_types
        out = h.new_empty(self.n_chunks * c, rel_kernels.shape[2])
        h = h.contiguous()
        for i, (snd, wgt, row_offsets, split) in enumerate(self.chunks):
            agg = csr_segment_sum(h, snd, row_offsets, wgt, split)  # [R * C, F_in]
            out[i * c:(i + 1) * c] = torch.einsum("rcf,rfo->co", agg.view(nr, c, -1),
                                                  rel_kernels)
        return out[:self.num_nodes]

    @torch.no_grad()
    def __call__(self, model, x: torch.Tensor, node_type: torch.Tensor,
                 local_node_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-graph logits and penultimate features of ``model`` (an
        ``RGCN``) for node features ``x`` ``[N, F]`` on the device."""
        h, out_feat = model.embed(x, node_type, local_node_idx), None
        for i, conv in enumerate(model.convs):
            out = self._layer(h, torch.stack(list(conv.rel_weights)))
            for t, lin in enumerate(conv.root_lins):
                out = torch.where((node_type == t)[:, None], out + lin(h), out)
            h = out
            if i < len(model.convs) - 1:
                h = torch.relu(h)
                out_feat = h
        return h, out_feat
