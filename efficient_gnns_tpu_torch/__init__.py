"""PyTorch/CUDA port of ``efficient_gnns_tpu``.

The JAX package stays the reference; this package mirrors its module layout
(``graphs``, ``data``, ``ops``, ``models``, ``distill``, ``train``, ``cli``)
so each module's counterpart is found by name. It imports ``torch`` and
``numpy`` only. The sparse aggregation runs on a CUDA kernel written for
Hopper (``ops/cuda``); on CPU tensors the same function runs as plain PyTorch.

Ported so far: the GCN student path (graph build, synthetic data, static-
weight SpMM, ``GCN``, the ``supervised`` / ``kd`` criteria, the node trainer
and ``cli.arxiv``). See ROADMAP.md for what remains.
"""
