"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc``: each kernel is built at its
first launch. Without a card they skip. The file imports only torch, numpy
and the port, so that it collects where the JAX package does not import
(its conftest imports JAX); on a machine with a card run it alone with

    python -m pytest --noconftest tests/test_torch_gpu.py

Tolerance: rtol 1e-5 / atol 1e-5 (1e-4 for the multi-head kernels), the
summation order of the kernel against ``index_add_`` or a gathered product
summed by PyTorch; the max and the row broadcast are exact. A kernel gives
the same bits at every launch, and with the row split derived at the call.
"""

import numpy as np
import pytest
import torch

from efficient_gnns_tpu_torch.graphs import build_graph, build_row_split
from efficient_gnns_tpu_torch.ops import dispatch
from efficient_gnns_tpu_torch.ops import hub_attention as hub
from efficient_gnns_tpu_torch.ops.cuda import (
    csr_sddmm,
    csr_sddmm_heads,
    csr_sddmm_heads_plain,
    csr_sddmm_plain,
    csr_segment_max_thin,
    csr_segment_reduce_thin_plain,
    csr_segment_sum,
    csr_segment_sum_heads,
    csr_segment_sum_heads_plain,
    csr_segment_sum_plain,
    csr_segment_sum_thin,
    csr_tile_rows_thin,
    csr_tile_rows_thin_plain,
)

pytestmark = pytest.mark.gpu
N = 150


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _high_degree(rng, n=N, e=600, **kw):
    # receiver 0 owns 400 drawn edges (over 128 distinct ones): a hub row that
    # the row split cuts into chunks
    s = rng.integers(0, n, size=e)
    r = rng.integers(0, n, size=e)
    r[e // 3:] = 0
    return build_graph(s, r, n, edge_pad_multiple=64, **kw)


def _attention_edges(rng, n=70, e=3000):
    s = rng.integers(5, n, size=e)  # nodes 0-4 send nothing
    r = rng.integers(0, n - 10, size=e)  # nodes 60-69 receive nothing
    r[: e // 4] = 3  # a receiver of high degree
    s[e // 4: e // 2] = 11  # a sender of high degree
    s[e // 2: e // 2 + 20] = s[e // 2 + 20: e // 2 + 40]  # multi-edges
    r[e // 2: e // 2 + 20] = r[e // 2 + 20: e // 2 + 40]
    return s, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [40, 256, 3])
def test_k1_kernel_matches_plain_on_card(rng, cuda_device, f, dtype):
    g = _high_degree(rng, bidirected=True, self_loops=True, gcn_norm=True).to(cuda_device)
    assert g.row_split.num_long >= 1 and g.row_split.num_chunks >= 2
    x = torch.from_numpy(rng.normal(size=(N, f)).astype(np.float32)).to(cuda_device, dtype)
    launches = csr_segment_sum.launches
    for src, ro, w, split in ((g.senders, g.row_offsets, g.edge_weight, g.row_split),
                              (g.t_senders, g.t_row_offsets, g.t_edge_weight, g.t_row_split),
                              (g.senders, g.row_offsets, None, g.row_split)):
        got = csr_segment_sum(x, src, ro, w, split)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, csr_segment_sum_plain(x, src, ro, w),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(got, csr_segment_sum(x, src, ro, w, split))
        assert torch.equal(got, csr_segment_sum(x, src, ro, w))
    assert csr_segment_sum.launches == launches + 9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [40, 256, 3])
def test_k3_kernel_matches_plain_on_card(rng, cuda_device, f, dtype):
    graph = _high_degree(rng).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(N, f)).astype(np.float32)).to(cuda_device, dtype)
    x = torch.from_numpy(rng.normal(size=(N, f)).astype(np.float32)).to(cuda_device, dtype)
    launches = csr_sddmm.launches
    args = (graph.senders, graph.row_offsets)
    got = csr_sddmm(g, x, *args, graph.row_split)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, csr_sddmm_plain(g, x, *args), rtol=1e-5, atol=1e-5)
    assert csr_sddmm.launches == launches + 1


@pytest.mark.parametrize("f", [131, 600])
@pytest.mark.parametrize("threshold", [16, 128])
def test_k3_walk_is_split_free_on_card(rng, cuda_device, threshold, f):
    # rows wider than one pass of the lanes (131 floats, odd: one float a
    # load, two passes of 128 columns; 600 in 16-byte loads: two passes of
    # 512) and another chunk size give the same bits
    graph = _high_degree(rng).to(cuda_device)
    g = torch.randn(N, f, device=cuda_device)
    x = torch.randn(N, f, device=cuda_device)
    args = (graph.senders, graph.row_offsets)
    got = csr_sddmm(g, x, *args, graph.row_split)
    torch.testing.assert_close(got, csr_sddmm_plain(g, x, *args), rtol=1e-5, atol=1e-4)
    other = build_row_split(graph.row_offsets, threshold).to(cuda_device)
    assert torch.equal(got, csr_sddmm(g, x, *args, other))
    assert torch.equal(got, csr_sddmm(g, x, *args, graph.row_split))
    assert not got[graph.n_edge:].any()


@pytest.mark.parametrize("heads,d", [(3, 250), (1, 40), (3, 5)])
def test_attention_kernels_match_plain_on_card(rng, cuda_device, heads, d):
    # receiver 3 and sender 11 own 750 edges each: hub rows of both orders,
    # which the row split cuts into chunks for K2, K4, K5 and K6
    n = 70
    s, r = _attention_edges(rng)
    g = build_graph(s, r, n, edge_pad_multiple=512).to(cuda_device)
    assert g.row_split.num_long >= 1 and g.t_row_split.num_long >= 1
    x = torch.randn(n, heads * d, device=cuda_device)
    gg = torch.randn(n, heads * d, device=cuda_device)
    w = torch.randn(g.num_edges_padded, heads, device=cuda_device)
    vals = torch.randn(n, heads, device=cuda_device)
    for src, dst, ro, split in ((g.senders, g.receivers, g.row_offsets, g.row_split),
                                (g.t_senders, g.t_receivers, g.t_row_offsets,
                                 g.t_row_split)):
        close = dict(rtol=1e-5, atol=1e-4)
        got = csr_segment_sum_heads(x, w, src, ro, split)
        torch.testing.assert_close(got, csr_segment_sum_heads_plain(x, w, src, ro), **close)
        assert torch.equal(got, csr_segment_sum_heads(x, w, src, ro, split))
        assert torch.equal(got, csr_segment_sum_heads(x, w, src, ro))
        got = csr_sddmm_heads(gg, x, src, ro, heads, split)
        torch.testing.assert_close(got, csr_sddmm_heads_plain(gg, x, src, ro, heads), **close)
        assert torch.equal(got, csr_sddmm_heads(gg, x, src, ro, heads))
        assert torch.equal(got, csr_sddmm_heads(gg, x, src, ro, heads,
                                                build_row_split(ro, 16).to(cuda_device)))
        for fn, op in ((csr_segment_sum_thin, "sum"), (csr_segment_max_thin, "max")):
            got = fn(w, ro, split)
            want = csr_segment_reduce_thin_plain(w, ro, op)
            if op == "sum":
                torch.testing.assert_close(got, want, **close)
            else:
                assert torch.equal(got, want)
            assert torch.equal(got, fn(w, ro, split)) and torch.equal(got, fn(w, ro))
        want = csr_tile_rows_thin_plain(vals, dst, ro)
        assert torch.equal(csr_tile_rows_thin(vals, dst, ro), want)
        # dst as a view that is not 16-byte aligned, E_pad not a multiple of 4
        shifted = torch.cat([dst[:1], dst])[1:-2]
        assert shifted.data_ptr() % 16 and shifted.shape[0] % 4
        assert torch.equal(csr_tile_rows_thin(vals, shifted, ro), want[:-2])
    torch.cuda.synchronize()


@pytest.mark.parametrize("seed", [None, 2**32 - 9])
@pytest.mark.parametrize("h,d", [(3, 250), (1, 40), (2, 128)])
def test_hub_attention_on_card_matches_cpu(rng, cuda_device, h, d, seed):
    s, r = _attention_edges(rng)
    graph = build_graph(s, r, 70, bidirected=True, self_loops=True, hub_dense=8,
                        edge_pad_multiple=512)
    feat = torch.from_numpy(rng.normal(size=(70, h, d)).astype(np.float32))
    el = torch.from_numpy(rng.normal(size=(70, h)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(70, h, d)).astype(np.float32))
    drop_seed = None if seed is None else torch.tensor(seed)
    dispatch.set_hub_message_dtype(torch.float32)
    try:
        results = {}
        for dev in ("cpu", cuda_device):
            f = feat.to(dev, copy=True).requires_grad_()
            e = el.to(dev, copy=True).requires_grad_()
            sd = None if drop_seed is None else drop_seed.to(dev)
            out = hub.hub_gat_attention(graph.to(dev), f, e, edge_drop=0.3, drop_seed=sd)
            (out * cot.to(dev)).sum().backward()
            keep = (None if sd is None else
                    hub.hub_keep_weights(graph.to(dev), sd, 0.7).cpu())
            results[str(dev)] = (out.detach().cpu(), f.grad.cpu(), e.grad.cpu(), keep)
    finally:
        dispatch.set_hub_message_dtype(torch.bfloat16)
    cpu, card = results["cpu"], results[str(cuda_device)]
    for a, b in zip(card[:3], cpu[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if seed is not None:  # the same seed keeps the same edges on both devices
        assert torch.equal(card[3], cpu[3])


@pytest.mark.parametrize("gcn_norm", [True, False])
def test_sign_hop_features_on_card_match_cpu(rng, cuda_device, gcn_norm):
    from efficient_gnns_tpu_torch.ops.cuda import segment_sum
    from efficient_gnns_tpu_torch.sampling import neighbor_average_features

    graph = _high_degree(rng, bidirected=True, self_loops=True, gcn_norm=gcn_norm)
    x = torch.from_numpy(rng.normal(size=(N, 128)).astype(np.float32))
    want = neighbor_average_features(graph, x, 3)
    segment_sum.csr_segment_sum.launches = 0
    got = neighbor_average_features(graph.to(cuda_device), x.to(cuda_device), 3)
    assert segment_sum.csr_segment_sum.launches == 3  # K1 once a hop
    # each entry within 1e-5 of its sum of |terms| (the same hops over |x|:
    # the weights are positive), however small a late hop's entries are
    terms = neighbor_average_features(graph, x.abs(), 3)
    for g, w, t in zip(got, want, terms):
        assert bool(((g.cpu() - w).abs() <= 1e-5 * t).all())


@pytest.mark.parametrize("mode,kd_and_aux", [("supervised", False), ("nce", True)])
def test_sign_trainer_epoch_on_card_matches_cpu(rng, cuda_device, mode, kd_and_aux):
    from efficient_gnns_tpu_torch.train import DistillConfig, SIGNTrainer

    n = 300
    feats = [rng.normal(size=(n, 16)).astype(np.float32) for _ in range(3)]
    y = rng.integers(0, 4, size=n)
    split = {"train": np.arange(0, 150), "valid": np.arange(150, 220),
             "test": np.arange(220, n)}
    t_feat = rng.normal(size=(n, 8)).astype(np.float32)
    t_logits = rng.normal(size=(n, 4)).astype(np.float32)
    cfg = DistillConfig(training=mode, kd_and_aux=kd_and_aux, hidden=32, dropout=0.0,
                        lr=0.01, beta=1.0, max_samples=64, proj_dim=8)
    results = {}
    for dev in ("cpu", cuda_device):  # batches of 64: the last one padded
        # the hop features as the CLI hands them over: tensors on the device
        on_dev = [torch.from_numpy(f).to(dev) for f in feats]
        tr = SIGNTrainer(cfg, on_dev, y, split, 4, batch_size=64, eval_batch_size=128,
                         teacher_feat=t_feat, teacher_logits=t_logits, device=dev)
        results[str(dev)] = [tr.train_epoch(e)["loss"] for e in (1, 2)] + list(tr.evaluate())
    np.testing.assert_allclose(results[str(cuda_device)][:2], results["cpu"][:2], rtol=1e-4)
    np.testing.assert_allclose(results[str(cuda_device)][2:], results["cpu"][2:], atol=0.02)


@pytest.mark.parametrize("heads,d", [(6, 121), (2, 121), (4, 256), (2, 68)])
def test_attention_kernels_without_long_rows_on_card(rng, cuda_device, heads, d):
    # the PPI graphs' shape: no row above the split threshold, so the split
    # is empty (num_chunks = num_long = 0, an empty partial scratch, no second
    # pass), padding nodes with empty rows, and D = 121 (odd: one float a load)
    from efficient_gnns_tpu_torch.data import synthetic_ppi_dataset

    g = synthetic_ppi_dataset(n_train=1, n_valid=0, n_test=0, min_nodes=300,
                              max_nodes=400, avg_deg=14, seed=3).train[0].graph
    assert g.row_split.num_chunks == g.row_split.num_long == g.t_row_split.num_long == 0
    g = g.to(cuda_device)
    n = g.num_nodes
    x = torch.randn(n, heads * d, device=cuda_device)
    gg = torch.randn(n, heads * d, device=cuda_device)
    w = torch.randn(g.num_edges_padded, heads, device=cuda_device)
    vals = torch.randn(n, heads, device=cuda_device)
    close = dict(rtol=1e-5, atol=1e-4)
    for src, dst, ro, split in ((g.senders, g.receivers, g.row_offsets, g.row_split),
                                (g.t_senders, g.t_receivers, g.t_row_offsets,
                                 g.t_row_split)):
        got = csr_segment_sum_heads(x, w, src, ro, split)
        torch.testing.assert_close(got, csr_segment_sum_heads_plain(x, w, src, ro), **close)
        assert torch.equal(got, csr_segment_sum_heads(x, w, src, ro, split))
        got = csr_sddmm_heads(gg, x, src, ro, heads, split)
        torch.testing.assert_close(got, csr_sddmm_heads_plain(gg, x, src, ro, heads), **close)
        assert torch.equal(got, csr_sddmm_heads(gg, x, src, ro, heads, split))
        for fn, op in ((csr_segment_sum_thin, "sum"), (csr_segment_max_thin, "max")):
            got = fn(w, ro, split)
            want = csr_segment_reduce_thin_plain(w, ro, op)
            if op == "sum":
                torch.testing.assert_close(got, want, **close)
            else:
                assert torch.equal(got, want)
            assert torch.equal(got, fn(w, ro, split))
        got = csr_tile_rows_thin(vals, dst, ro)
        assert torch.equal(got, csr_tile_rows_thin_plain(vals, dst, ro))
        assert torch.equal(got, csr_tile_rows_thin(vals, dst, ro))
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode,kd_and_aux", [("supervised", False), ("nce", True)])
def test_ppi_trainer_epoch_on_card_matches_cpu(cuda_device, mode, kd_and_aux):
    from efficient_gnns_tpu_torch.data import synthetic_ppi_dataset
    from efficient_gnns_tpu_torch.models import PPIGAT
    from efficient_gnns_tpu_torch.train import DistillConfig, PPITrainer

    ds = synthetic_ppi_dataset(n_train=3, n_valid=1, n_test=1, min_nodes=40, max_nodes=80,
                               avg_deg=5, feat_dim=16, num_labels=12, seed=0)
    cfg = DistillConfig(training=mode, kd_and_aux=kd_and_aux, lr=0.005, alpha=0.5,
                        kd_T=1.0, beta=1.0, max_samples=128, proj_dim=8)
    results = {}
    for dev in ("cpu", cuda_device):  # max_samples at the padded rows: no row subset
        teacher = PPIGAT(16, 12, 12, 2, heads=2, seed=1, device=dev)
        tr = PPITrainer(cfg, ds, PPIGAT(16, 8, 12, 2, heads=2, seed=0, device=dev),
                        teacher=teacher, teacher_feat_dim=24, seed=0, device=dev)
        results[str(dev)] = ([tr.train_epoch(e)["loss"] for e in (1, 2)]
                             + list(tr.evaluate_all()))
    np.testing.assert_allclose(results[str(cuda_device)][:2], results["cpu"][:2], rtol=1e-4)
    np.testing.assert_allclose(results[str(cuda_device)][2:], results["cpu"][2:], atol=0.02)
