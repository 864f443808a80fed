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

import dataclasses

import numpy as np
import pytest
import torch

from efficient_gnns_tpu_torch.analysis.timing import device_memory_stats
from efficient_gnns_tpu_torch.graphs import build_graph, build_row_split
from efficient_gnns_tpu_torch.ops import dispatch, sddmm_dot
from efficient_gnns_tpu_torch.ops import hub_attention as hub
from efficient_gnns_tpu_torch.ops.cuda import hub_fused
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


@pytest.mark.parametrize("heads,d,vec", [(3, 250, 2), (1, 121, 1), (2, 68, 2), (1, 40, 8)])
def test_heads_kernels_bf16_match_plain_on_card(rng, cuda_device, heads, d, vec):
    # K2 and K4 reading bfloat16 messages in loads of 8, 2 and 1 elements;
    # the plain versions form the same float32 products of the bf16 values
    from efficient_gnns_tpu_torch.ops.cuda.launch import float_vec

    n = 70
    s, r = _attention_edges(rng)
    g = build_graph(s, r, n, edge_pad_multiple=512).to(cuda_device)
    x = torch.randn(n, heads * d, device=cuda_device).bfloat16()
    gg = torch.randn(n, heads * d, device=cuda_device).bfloat16()
    w = torch.randn(g.num_edges_padded, heads, device=cuda_device)
    assert float_vec(torch.bfloat16, d, x.data_ptr()) == vec
    k2, k4 = csr_segment_sum_heads.launches, csr_sddmm_heads.launches
    close = dict(rtol=1e-5, atol=1e-4)
    for src, ro, split in ((g.senders, g.row_offsets, g.row_split),
                           (g.t_senders, g.t_row_offsets, g.t_row_split)):
        got = csr_segment_sum_heads(x, w, src, ro, split)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, csr_segment_sum_heads_plain(x, w, src, ro), **close)
        torch.testing.assert_close(got, csr_segment_sum_heads_plain(x.float(), w, src, ro),
                                   **close)
        assert torch.equal(got, csr_segment_sum_heads(x, w, src, ro, split))
        assert torch.equal(got, csr_segment_sum_heads(x, w, src, ro))
        got = csr_sddmm_heads(gg, x, src, ro, heads, split)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, csr_sddmm_heads_plain(gg, x, src, ro, heads), **close)
        assert torch.equal(got, csr_sddmm_heads(gg, x, src, ro, heads, split))
        assert torch.equal(got, csr_sddmm_heads(gg, x, src, ro, heads))
        assert not got[g.n_edge:].any()
    assert csr_segment_sum_heads.launches == k2 + 6
    assert csr_sddmm_heads.launches == k4 + 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sddmm_dot_on_card_matches_cpu(rng, cuda_device, dtype):
    # forward K3, backward two K1 sums; the CPU takes the plain versions
    graph = _high_degree(rng)
    a = torch.from_numpy(rng.normal(size=(N, 40)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(size=(N, 40)).astype(np.float32)).to(dtype)
    cot = torch.from_numpy(rng.normal(size=graph.num_edges_padded).astype(np.float32))
    k1, k3 = csr_segment_sum.launches, csr_sddmm.launches
    outs = []
    for dev in ("cpu", cuda_device):
        ta = a.to(dev, copy=True).requires_grad_(True)
        tb = b.to(dev, copy=True).requires_grad_(True)
        out = sddmm_dot(graph.to(dev), ta, tb)
        (out.float() * cot.to(dev)).sum().backward()
        outs.append([t.detach().float().cpu() for t in (out, ta.grad, tb.grad)])
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-4)
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, **tol)
    assert not outs[1][0][graph.n_edge:].any()
    assert (csr_segment_sum.launches, csr_sddmm.launches) == (k1 + 2, k3 + 1)


def test_device_memory_stats_on_card(cuda_device):
    x = torch.empty(1 << 20, device=cuda_device)
    stats = device_memory_stats(cuda_device)
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"] >= x.numel() * 4
    assert stats["bytes_limit"] > stats["peak_bytes_in_use"]


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


@pytest.mark.parametrize("msg_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(3, 250), (1, 40), (2, 128), (2, 5)])
def test_hub_fused_kernels_match_plain_on_card(rng, cuda_device, h, d, msg_dtype):
    # forward passes and the backward's elementwise columns: the same bits;
    # the two sums over D (the scalar column of the cotangent, dz) in
    # another order
    n = 300
    dp, hp = hub_fused.hub_layout(h, d)
    x = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    z = torch.from_numpy(rng.uniform(1e-3, 1.0, size=(n, h)).astype(np.float32))
    total = torch.from_numpy(rng.normal(size=(n, h * dp + hp)).astype(np.float32))
    _, den = hub_fused._unfold(total, h, d)
    den.abs_().add_(0.5)
    den[:7] = torch.tensor([0.0, 1e-39, 1e-6, 1e-3, 1.0, 3e30, 1e-44])[:, None]
    scale = torch.from_numpy(rng.uniform(1, 3, size=n).astype(np.float32))
    res = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(n, h * dp + hp)).astype(np.float32))
    dev = {k: t.to(cuda_device) for k, t in dict(x=x, z=z, total=total, scale=scale, res=res,
                                                 g=g, dy=dy).items()}
    counts = [f.launches for f in (hub_fused.hub_messages, hub_fused.hub_epilogue,
                                   hub_fused.hub_cotangent, hub_fused.hub_message_grad)]
    got = hub_fused.hub_messages(dev["x"], dev["z"], msg_dtype)
    assert torch.equal(got.cpu(), hub_fused.hub_messages_plain(x, z, msg_dtype))
    for sc, rs in ((scale, res), (None, None)):
        got = hub_fused.hub_epilogue(dev["total"], h, d, None if sc is None else dev["scale"],
                                     None if rs is None else dev["res"])
        assert torch.equal(got.cpu(), hub_fused.hub_epilogue_plain(total, h, d, sc, rs))
    got = hub_fused.hub_cotangent(dev["g"], dev["total"], dev["scale"], torch.float32).cpu()
    want = hub_fused.hub_cotangent_plain(g, total, scale, torch.float32)
    (gb, gc), (wb, wc) = hub_fused._unfold(got, h, d), hub_fused._unfold(want, h, d)
    assert torch.equal(gb, wb) and torch.isfinite(got).all()
    torch.testing.assert_close(gc, wc, rtol=1e-5, atol=1e-5 * float(wc.abs().max()))
    used = torch.zeros_like(got, dtype=torch.bool)
    for part in hub_fused._unfold(used, h, d):
        part.fill_(True)
    assert not got[~used].any()  # zeros elsewhere
    bf = hub_fused.hub_cotangent(dev["g"], dev["total"], dev["scale"], msg_dtype).cpu()
    assert bf.dtype == msg_dtype and torch.equal(hub_fused._unfold(bf, h, d)[0], wb.to(msg_dtype))
    dx, dz = hub_fused.hub_message_grad(dev["dy"], dev["x"], dev["z"])
    wx, wz = hub_fused.hub_message_grad_plain(dy, x, z)
    assert torch.equal(dx.cpu(), wx)
    torch.testing.assert_close(dz.cpu(), wz, rtol=1e-5, atol=1e-5)
    assert [f.launches for f in (hub_fused.hub_messages, hub_fused.hub_epilogue,
                                 hub_fused.hub_cotangent, hub_fused.hub_message_grad)] == [
        counts[0] + 1, counts[1] + 2, counts[2] + 2, counts[3] + 1]
    with pytest.raises(ValueError, match="one device"):
        hub_fused.hub_messages(dev["x"], z, msg_dtype)
    with pytest.raises(ValueError, match="one device"):
        hub_fused.hub_epilogue(dev["total"], h, d, scale, dev["res"])


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


def _typed_square(rng, nb=90, num_types=7, e=900):
    # the sampler's tall typed layout: senders at type * nb + s, receivers
    # below nb, per-(type, receiver) mean weights; receiver 0 holds a long row
    s = rng.integers(0, nb, size=e)
    r = rng.integers(0, nb, size=e)
    r[: e // 3] = 0
    et = rng.integers(0, num_types, size=e)
    cell = et * nb + r
    w = 1.0 / np.maximum(np.bincount(cell, minlength=num_types * nb)[cell], 1)
    return build_graph(s + et * nb, r, num_types * nb, edge_weight=w, edge_pad_multiple=256,
                       max_dst=nb)


@pytest.mark.parametrize("f", [512, 349, 32, 1])
def test_k1_on_the_tall_typed_graph_on_card(rng, cuda_device, f):
    g = _typed_square(rng).to(cuda_device)
    nb = g.max_dst
    assert g.row_split.num_long >= 1
    x = torch.from_numpy(rng.normal(size=(g.num_nodes, f)).astype(np.float32)).to(cuda_device)
    gy = torch.from_numpy(rng.normal(size=(nb, f)).astype(np.float32)).to(cuda_device)
    launches = csr_segment_sum.launches
    for src, ro, w, split, inp in (
            (g.senders, g.row_offsets[:nb + 1], g.edge_weight, g.dst_row_split, x),
            (g.senders, g.row_offsets, g.edge_weight, g.row_split, x),
            (g.t_senders, g.t_row_offsets, g.t_edge_weight, g.t_row_split, gy)):
        got = csr_segment_sum(inp, src, ro, w, split)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, csr_segment_sum_plain(inp, src, ro, w),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(got, csr_segment_sum(inp, src, ro, w, split))
    assert csr_segment_sum.launches == launches + 6
    from efficient_gnns_tpu_torch.ops import spmm

    # the typed forward's nb rows are the full product's first nb; its
    # gradient is the same either way
    xr = x.clone().requires_grad_(True)
    full = spmm(g, xr)
    (dfull,) = torch.autograd.grad((full[:nb] * gy).sum(), xr)
    rows = spmm(g, xr, dst_rows=True)
    (drows,) = torch.autograd.grad((rows * gy).sum(), xr)
    assert torch.equal(rows, full[:nb]) and torch.equal(drows, dfull)
    assert not full[nb:].any()


@pytest.mark.parametrize("mode,typed", [("supervised", True), ("kd", False), ("nce", True)])
def test_mag_trainer_epoch_on_card_matches_cpu(cuda_device, mode, typed):
    from efficient_gnns_tpu_torch.data import synthetic_mag_dataset
    from efficient_gnns_tpu_torch.train import DistillConfig, MagTrainer

    ds = synthetic_mag_dataset(n_paper=300, n_author=150, n_inst=10, n_field=30,
                               feat_dim=16, num_classes=4, seed=3)
    cfg = DistillConfig(training=mode, hidden=8, num_layers=2, dropout=0.0, lr=0.01,
                        beta=1.0, max_samples=4096, proj_dim=8)
    results = {}
    for dev in ("cpu", cuda_device):  # max_samples above the node budget: no row subset
        tr = MagTrainer(cfg, ds, batch_size=48, num_steps=3, seed=0, teacher_hidden=12,
                        teacher_layers=2, typed_square=typed, device=dev)
        try:
            results[str(dev)] = [tr.train_epoch(e)["loss"] for e in (1, 2)]
            logits = tr.logits().cpu()
        finally:
            tr.close()
        results[str(dev)] += [logits, tr.logits(layerwise=False).cpu()]
    got, want = results[str(cuda_device)], results["cpu"]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-4)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def _mol_pack(rng):
    # a long pool row (a molecule above the split threshold whose atom 0
    # receives a long row of bonds), an atom without bonds and an empty
    # padded graph
    from efficient_gnns_tpu_torch.graphs import ROW_SPLIT_THRESHOLD, pack_graphs

    graphs = []
    for n in (7, ROW_SPLIT_THRESHOLD + 40, 5):
        s = rng.integers(0, n, size=2 * n)
        r = rng.integers(0, n, size=2 * n)
        if n > ROW_SPLIT_THRESHOLD:
            r[: ROW_SPLIT_THRESHOLD + 20] = 0
        graphs.append((s, r, n))
    graphs.append((np.array([0]), np.array([1]), 3))
    batch, _, _ = pack_graphs(graphs, pad_nodes_to=256, pad_edges_to=512, pad_graphs_to=6)
    assert batch.graph.row_split.num_long == 1 and batch.graph_split.num_long == 1
    return batch


@pytest.mark.parametrize("f", [300, 64, 7])
def test_sorted_segment_ops_on_card_match_plain(rng, cuda_device, f):
    from efficient_gnns_tpu_torch.ops.sorted_segment import (
        csr_segment_sum_sorted,
        gather_rows_csr,
    )

    cpu = _mol_pack(rng)
    card = cpu.to(cuda_device)
    sums = {  # data rows, ids and the CSR of each sorted sum
        "edges": lambda b: (b.graph.receivers, b.graph.row_offsets, b.graph.row_split),
        "pool": lambda b: (b.node_graph_ids, b.graph_offsets, b.graph_split),
    }
    for name, parts in sums.items():
        ids = parts(cpu)[0]
        data = torch.from_numpy(rng.normal(size=(ids.shape[0], f)).astype(np.float32))
        rows = parts(cpu)[1].numel() - 1
        cot = torch.from_numpy(rng.normal(size=(rows, f)).astype(np.float32))
        out = {}
        for b, dev in ((cpu, "cpu"), (card, cuda_device)):
            x = data.to(dev, copy=True).requires_grad_(True)
            launches = csr_segment_sum.launches
            y = csr_segment_sum_sorted(x, *parts(b), b.ident)
            y.backward(cot.to(dev))
            out[str(dev)] = (y.detach().cpu(), x.grad.cpu(), csr_segment_sum.launches - launches)
        got, want = out[str(cuda_device)], out["cpu"]
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
        assert torch.equal(got[1], want[1]) and got[2] == 1, name  # backward: a gather
        assert torch.equal(got[0], csr_segment_sum_sorted(data.to(cuda_device), *parts(card),
                                                          card.ident).cpu())
    gathers = {  # rows of x, index and the transpose CSR of each gather
        "senders": lambda b: (b.graph.num_nodes, b.graph.senders, b.graph.t_row_offsets,
                              b.graph.csc_perm, b.graph.t_row_split),
        "receivers": lambda b: (b.graph.num_nodes, b.graph.receivers, b.graph.row_offsets,
                                b.ident, b.graph.row_split),
        "graph ids": lambda b: (b.num_graphs, b.node_graph_ids, b.graph_offsets, b.ident,
                                b.graph_split),
    }
    for name, parts in gathers.items():
        rows, idx = parts(cpu)[:2]
        data = torch.from_numpy(rng.normal(size=(rows, f)).astype(np.float32))
        cot = torch.from_numpy(rng.normal(size=(idx.shape[0], f)).astype(np.float32))
        out = {}
        for b, dev in ((cpu, "cpu"), (card, cuda_device)):
            x = data.to(dev, copy=True).requires_grad_(True)
            launches = csr_segment_sum.launches
            y = gather_rows_csr(x, *parts(b)[1:])
            y.backward(cot.to(dev))
            out[str(dev)] = (y.detach().cpu(), x.grad.cpu(), csr_segment_sum.launches - launches)
        got, want = out[str(cuda_device)], out["cpu"]
        assert torch.equal(got[0], want[0]) and got[2] == 1, name  # forward: a gather
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()


@pytest.mark.parametrize("conv,mode,kd_and_aux", [("gine", "supervised", False),
                                                   ("gcn", "nce", True), ("pna", "kd", False)])
def test_mol_trainer_epoch_on_card_matches_cpu(cuda_device, conv, mode, kd_and_aux):
    from efficient_gnns_tpu_torch.data import synthetic_molhiv_dataset
    from efficient_gnns_tpu_torch.models import MolGNN
    from efficient_gnns_tpu_torch.train import DistillConfig, MolTrainer

    ds = synthetic_molhiv_dataset(n_train=48, n_valid=16, n_test=16, seed=2)
    cfg = DistillConfig(training=mode, kd_and_aux=kd_and_aux, lr=0.003, alpha=0.5, kd_T=1.0,
                        beta=0.5, max_samples=16, proj_dim=8)
    results = {}
    for dev in ("cpu", cuda_device):  # max_samples at the batch size: no row subset
        teacher = MolGNN("gine", 24, 1, 2, virtual_node=True, seed=1, device=dev)
        student = MolGNN(conv, 16, 1, 2, dropout=0.0, virtual_node=conv == "gine",
                         pna_towers=4, pna_delta=ds.mean_log_degree, device=dev)
        tr = MolTrainer(cfg, ds, student, teacher=teacher, batch_size=16, max_atoms=24,
                        seed=0, device=dev)
        results[str(dev)] = ([tr.train_epoch(e)["loss"] for e in (1, 2)]
                             + list(tr.evaluate_all()))
    np.testing.assert_allclose(results[str(cuda_device)][:2], results["cpu"][:2], rtol=1e-4)
    np.testing.assert_allclose(results[str(cuda_device)][2:], results["cpu"][2:], atol=0.05)


def _mol_chain(n, rng):
    from efficient_gnns_tpu_torch.data.molhiv import Molecule

    s = np.arange(1, n)
    senders, receivers = np.concatenate([s, s - 1]), np.concatenate([s - 1, s])
    return Molecule(senders, receivers, n, rng.integers(0, 5, (n, 9)).astype(np.int32),
                    rng.integers(0, 2, (2 * n - 2, 3)).astype(np.int32), 1.0)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_mol_trainer_graphs_on_card_match_its_eager_steps(cuda_device, dropout):
    """Three epochs with the step and evaluation graphs against the same
    epochs stepped eagerly (a trainer told not to graph): the replays run
    the eager kernels on the same inputs and draw dropout from the same
    generator state, so the losses, ROC-AUCs and parameters agree (to
    1e-6: a matrix product may take another algorithm inside a capture). A 150-atom molecule gives a batch
    of its own signature (past the node budget, and a split pool row). The
    last trainer captures while the first, gone but not yet collected (it
    sits in a reference cycle), still holds its graphs."""
    from efficient_gnns_tpu_torch.data import synthetic_molhiv_dataset
    from efficient_gnns_tpu_torch.models import MolGNN
    from efficient_gnns_tpu_torch.train import DistillConfig, MolTrainer

    ds = synthetic_molhiv_dataset(n_train=60, n_valid=16, n_test=16, seed=3)
    ds = ds._replace(train=ds.train + [_mol_chain(150, np.random.default_rng(0))])
    got = []
    for graphs in (True, False, True):
        model = MolGNN("gine", 32, 1, 3, dropout=dropout, virtual_node=True,
                       virtual_node_norm=True, seed=1, device=cuda_device)
        tr = MolTrainer(DistillConfig(lr=0.003), ds, model, batch_size=8, max_atoms=24,
                        seed=0, device=cuda_device)
        assert tr.graphed
        tr.graphed = graphs  # the eager steps of the same trainer
        rows = tr.run_epochs(0, 3)
        got.append((rows, [p.detach().clone() for p in tr.modules.parameters()]))
        if graphs:
            assert len(tr._step_graphs) >= 2 and tr._eval_graph is not None
            assert tr._eager_steps == 2
        del tr, model
    for rows, params in (got[0], got[2]):
        np.testing.assert_allclose(rows, got[1][0], rtol=1e-6, atol=1e-6)
        for a, b in zip(params, got[1][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_mol_batch_moves_to_the_card(rng, cuda_device):
    from efficient_gnns_tpu_torch.data import MolBatcher, synthetic_molhiv_dataset
    from efficient_gnns_tpu_torch.graphs.row_split import is_recorded_pair

    ds = synthetic_molhiv_dataset(n_train=40, n_valid=1, n_test=1, seed=1)
    mb = next(MolBatcher(ds.train, 16, 24).epoch(0))
    moved = mb.to(cuda_device)
    torch.cuda.synchronize()
    for old, new in ((mb.batch.graph, moved.batch.graph), (mb.batch, moved.batch)):
        for f in dataclasses.fields(old):
            a, b = getattr(old, f.name), getattr(new, f.name)
            if isinstance(a, torch.Tensor):
                assert b.device.type == "cuda" and b.dtype == a.dtype and torch.equal(b.cpu(), a)
    for a, b in zip(mb[1:], moved[1:]):
        assert b.device.type == "cuda" and torch.equal(b.cpu(), a)
    g = moved.batch.graph
    assert is_recorded_pair(g.row_split, g.row_offsets)
    assert is_recorded_pair(g.t_row_split, g.t_row_offsets)
    assert is_recorded_pair(moved.batch.graph_split, moved.batch.graph_offsets)


# MaskedBatchNorm's kernels (ops/cuda/masked_bn.py) at the cells' shapes and
# around the row-count switch: (rows, features, rows outside the mask, mask)
BN_SHAPES = [
    (1280, 600, 460, True),  # a molhiv batch's GIN-E MLP, padding rows
    (1280, 300, 460, True),  # its BatchNorms after the convs
    (32, 600, 9, True),  # the virtual node's MLP over padded graphs
    (32, 300, 9, True),
    (169343, 750, 0, True),  # the GAT teacher, every row kept
    (169343, 256, 0, True),  # the GCN student
    (91445, 256, 0, False),  # a projection head on the train rows, no mask
    (2048, 300, 100, True),  # the one-kernel path's last row count
    (2049, 300, 100, True),  # the two-kernel path's first
    (700, 7, 150, True),  # an odd width
    (5000, 13, 900, False),
]


def _bn_inputs(n, f, pad, use_mask, seed=0):
    """x with column spreads 0.5-3.5 and means within about 4 (so float32
    rounding of x - mean stays near an ulp of x's spread), a mask with
    ``pad`` rows out, the affine, running statistics and a cotangent."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, f, generator=g) * (0.5 + 3 * torch.rand(f, generator=g))
         + 2 * torch.randn(f, generator=g))
    mask = None
    if use_mask:
        mask = torch.ones(n, dtype=torch.bool)
        mask[torch.randperm(n, generator=g)[:pad]] = False
    scale = 1 + 0.5 * torch.randn(f, generator=g)
    bias = 0.3 * torch.randn(f, generator=g)
    rm, rv = 0.1 * torch.randn(f, generator=g), 1 + torch.rand(f, generator=g)
    return x, mask, scale, bias, rm, rv, torch.randn(n, f, generator=g)


def _bn_run(fn, dev, dtype, x, mask, scale, bias, rm, rv, dy, training, relu, relu_mask=None):
    """``fn``'s output, its three gradients and the running statistics after
    one call on ``dev`` in ``dtype``. With ``relu_mask`` the ReLU's mask is
    that one (the kernel's, so that no z within rounding of 0 flips): ``fn``
    runs without its ReLU and the mask multiplies."""
    def cast(t):
        return t.to(dev, dtype if t.is_floating_point() else t.dtype, copy=True)

    xx, sc, bi = (cast(t).requires_grad_(True) for t in (x, scale, bias))
    rmm, rvv = cast(rm), cast(rv)
    y = fn(xx, None if mask is None else cast(mask), sc, bi, rmm, rvv, training=training,
           momentum=0.9, epsilon=1e-5, relu=relu and relu_mask is None)
    if relu_mask is not None:
        y = y * cast(relu_mask)
    y.backward(cast(dy))
    return [t.detach().double().cpu() for t in (y, xx.grad, sc.grad, bi.grad, rmm, rvv)]


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("n,f,pad,use_mask", BN_SHAPES)
def test_masked_bn_kernels_match_float64_on_card(cuda_device, n, f, pad, use_mask, training,
                                                 relu):
    """The kernels against the plain version in float64 (two-pass): ``y``,
    ``dx`` (rows outside the mask included), ``dscale``, ``dbias`` and the
    running statistics within float32 rounding, the same bits at a second
    call, and the kernels of the row count's path launched."""
    from efficient_gnns_tpu_torch.ops.cuda import masked_bn as M

    inputs = _bn_inputs(n, f, pad, use_mask)
    counts = [k.launches for k in M.KERNELS]
    got = _bn_run(M.masked_batch_norm, cuda_device, torch.float32, *inputs, training, relu)
    fired = {k.__name__ for k, c in zip(M.KERNELS, counts) if k.launches > c}
    again = _bn_run(M.masked_batch_norm, cuda_device, torch.float32, *inputs, training, relu)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    small = n <= M.SMALL_ROWS
    want = ({"bn_eval"} if not training else {"bn_fused"} if small
            else {"bn_partials", "bn_apply"})
    want |= {"bn_grad_fused"} if small else {"bn_grad_partials", "bn_grad_apply"}
    assert fired == want

    def plain(*a, **kw):
        return M.masked_batch_norm_plain(*a, two_pass=True, **kw)

    relu_mask = (got[0] > 0).float() if relu else None
    ref = _bn_run(plain, cuda_device, torch.float64, *inputs, training, relu, relu_mask)
    y, dx, dscale, dbias, rm, rv = got
    x, mask, _, _, rm0, rv0, dy = inputs
    x, dy = x.double(), dy.double()
    if training:
        rows = x if mask is None else x[mask]
        mean, var = rows.mean(0), rows.var(0, unbiased=False)
    else:
        mean, var = rm0.double(), rv0.double()
    xh = (x - mean) / torch.sqrt(var + 1e-5)
    dz = dy if relu_mask is None else dy * relu_mask.double()

    def close(a, b, scale):  # within float32 rounding of the quantity's scale
        assert float((a - b).abs().max()) <= 1e-5 * scale, float((a - b).abs().max()) / scale

    close(y, ref[0], float(ref[0].abs().max()))
    close(dx, ref[1], float(ref[1].abs().max()))
    close(dbias, ref[3], float(dz.abs().sum(0).max()))
    close(dscale, ref[2], float((dz * xh).abs().sum(0).max()))
    close(rm, ref[4], 1.0)
    close(rv, ref[5], float(ref[5].abs().max()))
    if mask is not None and (~mask).any():  # the direct term alone outside the mask
        out = ~mask
        close(dx[out], ref[1][out], float(ref[1][out].abs().max()))
    torch.cuda.synchronize()


def test_masked_bn_kernels_carry_the_models_on_card(rng, cuda_device):
    """A training step and an evaluation of the GCN student (3,000 rows: the
    two-kernel path), of the GAT teacher and of the molhiv GIN-E with its
    virtual node's BatchNorms (the one-kernel path; its steps replayed as
    CUDA graphs) go through the BatchNorm kernels, and the GCN's step on the
    card agrees with the CPU's."""
    from efficient_gnns_tpu_torch.data import synthetic_molhiv_dataset
    from efficient_gnns_tpu_torch.models import GCN, GATTeacher, MolGNN
    from efficient_gnns_tpu_torch.ops.cuda import masked_bn as M
    from efficient_gnns_tpu_torch.train import DistillConfig, MolTrainer

    def fired(step):
        before = {k.__name__: k.launches for k in M.KERNELS}
        step()
        torch.cuda.synchronize()
        return {k.__name__: k.launches - before[k.__name__] for k in M.KERNELS}

    n = 3000
    s, r = rng.integers(0, n, 12000), rng.integers(0, n, 12000)
    graph = build_graph(s, r, n, bidirected=True, self_loops=True)
    x = torch.from_numpy(rng.normal(size=(n, 12)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        model = GCN(12, 48, 5, 2, dropout=0.0, seed=3, device=dev)
        g = graph.to(dev)

        def gcn_step():
            logits, _ = model(g, x.to(dev))
            logits.square().mean().backward()
            model.eval()
            with torch.no_grad():
                out[str(dev)] = (logits.detach().cpu(), model(g, x.to(dev))[0].cpu(),
                                 [p.grad.cpu() for p in model.parameters()])
            model.train()

        counts = fired(gcn_step)
    assert counts == {"bn_fused": 0, "bn_partials": 1, "bn_apply": 1, "bn_eval": 1,
                      "bn_grad_fused": 0, "bn_grad_partials": 1, "bn_grad_apply": 1}
    for a, b in zip(out[str(cuda_device)][:2], out["cpu"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    for a, b in zip(out[str(cuda_device)][2], out["cpu"][2]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)

    small = _high_degree(rng).to(cuda_device)
    teacher = GATTeacher(10, 8, 4, num_layers=3, num_heads=2, device=cuda_device)
    feat = torch.randn(N, 10, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def gat_step():
        teacher(small, feat, gen)[0].sum().backward()
        teacher.eval()
        with torch.no_grad():
            teacher(small, feat)
        teacher.train()

    assert fired(gat_step) == {"bn_fused": 2, "bn_partials": 0, "bn_apply": 0, "bn_eval": 2,
                               "bn_grad_fused": 2, "bn_grad_partials": 0, "bn_grad_apply": 0}

    ds = synthetic_molhiv_dataset(n_train=32, n_valid=8, n_test=8, seed=3)
    mol = MolGNN("gine", 16, 1, 3, virtual_node=True, virtual_node_norm=True, seed=1,
                 device=cuda_device)
    tr = MolTrainer(DistillConfig(lr=0.003), ds, mol, batch_size=8, max_atoms=24, seed=0,
                    device=cuda_device)
    counts = fired(lambda: tr.run_epochs(0, 1))
    # 3 convs' MLPs + 3 after the convs + 2 x 2 in the virtual node: 10 a step,
    # eagerly in the first two steps and inside the capture of a signature's graph
    assert counts["bn_fused"] >= 2 * 10 and counts["bn_grad_fused"] >= 2 * 10
    assert counts["bn_eval"] >= 10
    assert counts["bn_partials"] == counts["bn_grad_partials"] == 0


# OGB's atom and bond encoders' kernels (ops/cuda/categorical.py): (rows,
# vocabularies, F) at the molhiv batch's shapes, past its budget and at
# widths that take 2- and 1-column loads
ATOM_DIMS = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_DIMS = (5, 6, 2)
ENC_SHAPES = [
    (1280, ATOM_DIMS, 300),  # a molhiv batch's atoms
    (4096, BOND_DIMS, 300),  # its bonds
    (1152, ATOM_DIMS, 300),  # a batch past the budget, padded to its own size
    (5120, BOND_DIMS, 300),
    (37, (7, 1, 3), 6),  # 2-column loads, a vocabulary of one
    (3000, (1, 252, 3), 7),  # 1-column loads, the kernels' 256 bins
    (0, BOND_DIMS, 300),  # no rows: zero gradients
]


def _enc_inputs(rows, vocab, f, seed=0):
    """ids drawn from two below to two above each vocabulary (so some are
    clipped), the tables and a cotangent, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.stack([torch.randint(-2, v + 2, (rows,), generator=g) for v in vocab], 1).int()
    tables = [torch.randn(v, f, generator=g) for v in vocab]
    return ids, tables, torch.randn(rows, f, generator=g)


def _enc_run(dev, ids, tables, dy):
    from efficient_gnns_tpu_torch.ops.cuda import categorical as C

    leaves = [w.to(dev).requires_grad_(True) for w in tables]
    out = C.categorical_encode(ids.to(dev), leaves)
    grads = torch.autograd.grad(out, leaves, dy.to(dev))
    return out.detach(), [g.detach() for g in grads]


@pytest.mark.parametrize("rows,vocab,f", ENC_SHAPES)
def test_categorical_kernels_match_the_chain_and_float64_on_card(cuda_device, rows, vocab, f):
    """The forward has the bits of the chain of ``F.embedding`` and adds; each
    table's gradient lies within 1e-5 of each output's sum of |terms| of a
    float64 sum (0 where no row takes the category); a second call gives the
    same bits; each wrapper counts one launch a call."""
    from efficient_gnns_tpu_torch.ops.cuda import categorical as C

    ids, tables, dy = _enc_inputs(rows, vocab, f)
    counts = [k.launches for k in C.KERNELS]
    out, grads = _enc_run(cuda_device, ids, tables, dy)
    assert [k.launches - c for k, c in zip(C.KERNELS, counts)] == [1, 1]
    chain = C.categorical_encode_plain(ids.to(cuda_device), [w.to(cuda_device) for w in tables])
    assert torch.equal(out, chain)
    again = _enc_run(cuda_device, ids, tables, dy)
    assert torch.equal(again[0], out) and all(torch.equal(a, b) for a, b in zip(again[1], grads))
    for t, (g, v) in enumerate(zip(grads, vocab)):
        k = ids[:, t].long().clamp(0, v - 1)
        want = torch.zeros(v, f, dtype=torch.float64).index_add_(0, k, dy.double())
        terms = torch.zeros(v, f, dtype=torch.float64).index_add_(0, k, dy.double().abs())
        diff = (g.cpu().double() - want).abs()
        assert bool((diff <= 1e-5 * terms).all()), float((diff / terms.clamp_min(1e-30)).max())
    torch.cuda.synchronize()


def test_categorical_kernels_replay_in_a_cuda_graph_on_card(cuda_device):
    """A captured forward and backward, replayed, give the eager call's bits,
    and read the static ids on each replay."""
    from efficient_gnns_tpu_torch.ops.cuda import categorical as C

    ids, tables, dy = _enc_inputs(1280, ATOM_DIMS, 300)
    s_ids, s_dy = ids.to(cuda_device), dy.to(cuda_device)
    leaves = [w.to(cuda_device).requires_grad_(True) for w in tables]

    def step():
        out = C.categorical_encode(s_ids, leaves)
        return (out, *torch.autograd.grad(out, leaves, s_dy))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = step()
    for seed in (0, 1):
        new_ids = _enc_inputs(1280, ATOM_DIMS, 300, seed=seed)[0]
        s_ids.copy_(new_ids)
        graph.replay()
        eager = step()
        assert all(torch.equal(a, b) for a, b in zip(static, eager))
    torch.cuda.synchronize()


def test_categorical_encoder_never_reaches_f_embedding_on_card(cuda_device, monkeypatch):
    """On the card ``CategoricalEncoder`` (and a ``MolGNN`` step) runs the
    kernels alone: ``F.embedding`` raises if called. CPU tensors take the
    chain; the wrapper refuses int64 ids and a table on another device."""
    from efficient_gnns_tpu_torch.data import MolBatcher, synthetic_molhiv_dataset
    from efficient_gnns_tpu_torch.models import MolGNN
    from efficient_gnns_tpu_torch.models import mol
    from efficient_gnns_tpu_torch.ops.cuda import categorical as C

    def refuse(*a, **kw):
        raise AssertionError("F.embedding reached")

    monkeypatch.setattr(torch.nn.functional, "embedding", refuse)
    gen = torch.Generator().manual_seed(0)
    enc = mol.bond_encoder(300, generator=gen, device=cuda_device)
    ids = _enc_inputs(4096, BOND_DIMS, 300)[0].to(cuda_device)
    counts = [k.launches for k in C.KERNELS]
    enc(ids).square().sum().backward()
    assert [k.launches - c for k, c in zip(C.KERNELS, counts)] == [1, 1]
    assert all(w.grad is not None for w in enc.embs)
    ds = synthetic_molhiv_dataset(n_train=16, n_valid=1, n_test=1, seed=1)
    mb = next(MolBatcher(ds.train, 16, 24).epoch(0)).to(cuda_device)
    model = MolGNN("gine", 32, 1, 2, dropout=0.0, virtual_node=True, seed=1,
                   device=cuda_device)
    counts = [k.launches for k in C.KERNELS]
    model(mb.batch, mb.atoms, mb.bonds)[0].sum().backward()
    assert [k.launches - c for k, c in zip(C.KERNELS, counts)] == [3, 3]
    with pytest.raises(AssertionError, match="F.embedding reached"):
        mol.bond_encoder(300, generator=gen, device="cpu")(ids.cpu())
    with pytest.raises(ValueError, match="feats must be .*int32"):
        enc(ids.long())
    with pytest.raises(ValueError, match="one device"):
        C.categorical_encode(ids, [w.detach().cpu() if i == 1 else w for i, w in
                                   enumerate(enc.embs)])
    torch.cuda.synchronize()
