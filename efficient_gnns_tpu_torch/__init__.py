"""PyTorch/CUDA port of ``efficient_gnns_tpu``.

The JAX package stays the reference; this package mirrors its module layout
(``graphs``, ``data``, ``ops``, ``models``, ``distill``, ``sampling``,
``train``, ``analysis``, ``cli``) so each module's counterpart is found by
name. It imports
``torch`` and ``numpy`` only. The sparse aggregation runs on CUDA kernels
written for Hopper (``ops/cuda``); on CPU tensors the same functions run as
plain PyTorch.

Ported: every workload (ogbn-arxiv with the GCN, SAGE and SIGN students
and the GAT teacher, PPI, ogbn-mag, ogbg-molhiv), every CLI, every
single-device module, the tooling of ``analysis`` and the multi-device
layer (``parallel``).
"""
