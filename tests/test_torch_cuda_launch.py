"""The seam where a hand-written kernel joins the program
(``ops/cuda/launch.py``): every wrapper's common refusals, the device it
refuses them on, its launch counters in the registry, and the sources that
the build finds. CPU only; the launches themselves are
``tests/test_torch_gpu.py``'s."""

import os

import pytest
import torch

from efficient_gnns_tpu_torch.ops import cuda as K
from efficient_gnns_tpu_torch.ops.cuda import build, launch
from efficient_gnns_tpu_torch.ops.cuda import hub_fused as H
from efficient_gnns_tpu_torch.ops.cuda import masked_bn as M

RO = torch.tensor([0, 2, 3, 3, 6], dtype=torch.int32)
SRC = torch.tensor([0, 1, 2, 3, 0, 1, 0, 0], dtype=torch.int32)  # two padding edges
N, E = 4, 8
HN, HH, HD = 6, 2, 40  # the hub passes' N, heads and D
BN_CALL = dict(training=True, momentum=0.9, epsilon=1e-5, relu=True)


def _cases():
    """name -> (the wrapper, valid CPU arguments, the registry's labels of its
    counted kernels, its source in ``csrc/``, the name its messages give a
    tensor where it is not the argument's)."""
    dp, hp = H.hub_layout(HH, HD)
    x, z = torch.randn(HN, HH, HD), torch.rand(HN, HH) + 0.1
    wide = torch.randn(HN, HH * dp + hp)
    f = 5
    values = {"v": "values", "vals": "values"}
    return {
        "K1 csr_segment_sum": (K.csr_segment_sum, dict(
            x=torch.randn(N, 8), src=SRC, row_offsets=RO, w=torch.rand(E)),
            ["K1"], "segment_sum", {}),
        "K2 csr_segment_sum_heads": (K.csr_segment_sum_heads, dict(
            x=torch.randn(N, 6), w=torch.rand(E, 2), src=SRC, row_offsets=RO),
            ["K2"], "segment_heads", {}),
        "K3 csr_sddmm": (K.csr_sddmm, dict(
            g=torch.randn(N, 8), x=torch.randn(N, 8), src=SRC, row_offsets=RO),
            ["K3"], "segment_sddmm", {}),
        "K4 csr_sddmm_heads": (K.csr_sddmm_heads, dict(
            g=torch.randn(N, 6), x=torch.randn(N, 6), src=SRC, row_offsets=RO, num_heads=2),
            ["K4"], "segment_heads", {}),
        "K5 csr_segment_sum_thin": (K.csr_segment_sum_thin, dict(
            v=torch.randn(E, 2), row_offsets=RO), ["K5"], "segment_thin", values),
        "K6 csr_segment_max_thin": (K.csr_segment_max_thin, dict(
            v=torch.randn(E, 2), row_offsets=RO), ["K6"], "segment_thin", values),
        "K7 csr_tile_rows_thin": (K.csr_tile_rows_thin, dict(
            vals=torch.randn(N, 2), dst=SRC, row_offsets=RO), ["K7"], "segment_thin", values),
        "hub_messages": (H.hub_messages, dict(x=x, z=z, msg_dtype=torch.bfloat16),
                         ["hub_messages"], "hub_fused", {}),
        "hub_epilogue": (H.hub_epilogue, dict(
            total=wide, heads=HH, d=HD, scale=torch.ones(HN), res=x),
            ["hub_epilogue"], "hub_fused", {}),
        "hub_cotangent": (H.hub_cotangent, dict(
            g=x, total=wide, scale=torch.ones(HN), msg_dtype=torch.float32),
            ["hub_cotangent"], "hub_fused", {}),
        "hub_message_grad": (H.hub_message_grad, dict(dy=wide, x=x, z=z),
                             ["hub_message_grad"], "hub_fused", {}),
        "masked_batch_norm": (M.masked_batch_norm, dict(
            x=torch.randn(HN, f), mask=torch.arange(HN) < 4, scale=torch.rand(f) + 0.5,
            bias=torch.randn(f), running_mean=torch.zeros(f), running_var=torch.ones(f)),
            [k.__name__ for k in M.KERNELS], "masked_bn", {}),
    }


def _strided(t):
    if t.dim() > 1:
        return t.transpose(0, -1).contiguous().transpose(0, -1)
    return t.repeat_interleave(2)[::2]


def _other_dtype(t):
    return {torch.int32: torch.int64, torch.bool: torch.int32}.get(t.dtype, torch.float64)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_every_wrapper_refuses_alike_and_counts_its_launches_in_the_registry(name):
    fn, kw, labels, source, shown = _cases()[name]
    bn = fn is M.masked_batch_norm
    # masked_batch_norm refuses on CUDA only (on the CPU it runs the plain
    # chain, which takes any float): its checks are called as it calls them
    refuse = (lambda **a: M._check(**a)) if bn else fn
    if bn:
        kw64 = dict(kw, x=kw["x"].double())
        got = fn(**kw64, **BN_CALL)
        assert got.dtype == torch.float64  # not refused on the CPU
    keys = [k for k, t in kw.items() if isinstance(t, torch.Tensor)]
    for i, key in enumerate(keys):
        t, label = kw[key], shown.get(key, key)
        word = {torch.int32: "int32", torch.bool: "bool"}.get(t.dtype, "float32")
        with pytest.raises(ValueError, match=rf"{label} must be .*{word}"):
            refuse(**{**kw, key: t.to(_other_dtype(t))})
        with pytest.raises(ValueError, match="must be" if fn.__module__ == H.__name__
                           else rf"{label} must be"):
            refuse(**{**kw, key: t[..., None]})
        with pytest.raises(ValueError, match="contiguous"):
            refuse(**{**kw, key: _strided(t)})
        if i:  # mixed devices: a tensor other than the first on another
            with pytest.raises(ValueError, match=rf"{key}\b.* on cpu" if bn else "one device"):
                refuse(**{**kw, key: torch.empty(t.shape, dtype=t.dtype, device="meta")})
    meta = {k: torch.empty(t.shape, dtype=t.dtype, device="meta") if k in keys else t
            for k, t in kw.items()}
    with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
        fn(**meta, **(BN_CALL if bn else {}))
    counters = [launch.COUNTED[label] for label in labels]
    before = [c.launches for c in counters]
    fn(**kw, **(BN_CALL if bn else {}))  # the plain version on the CPU launches nothing
    assert [c.launches for c in counters] == before
    assert all(isinstance(c.launches, int) for c in counters)
    assert len({id(c) for c in launch.COUNTED.values()}) == len(launch.COUNTED)
    if not bn:
        assert launch.COUNTED[labels[0]] is fn
    csrc = os.path.join(os.path.dirname(build.__file__), "csrc")
    assert build.SOURCES == tuple(sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu")))
    assert source in build.SOURCES
