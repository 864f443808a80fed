"""PyTorch/CUDA port of ``efficient_gnns_tpu``.

The JAX package stays the reference; this package mirrors its module layout
(``graphs``, ``data``, ``ops``, ``models``, ``distill``, ``sampling``,
``train``, ``cli``) so each module's counterpart is found by name. It imports
``torch`` and ``numpy`` only. The sparse aggregation runs on CUDA kernels
written for Hopper (``ops/cuda``); on CPU tensors the same functions run as
plain PyTorch.

Ported so far: the ogbn-arxiv workload (the GCN, SAGE and SIGN students in
every distillation mode, the GAT teacher, checkpoints, the OGB loader and
the ``arxiv``, ``gat_teacher`` and ``sign`` CLIs). See ROADMAP.md for what
remains.
"""
