"""MaskedBatchNorm's wrapper (``ops/cuda/masked_bn.py``) on the CPU: its plain
version is the layer's chain of PyTorch ops as it ran before the kernels, bit
for bit (the output, the three gradients and the running statistics), in
training and eval mode, one- and two-pass, with and without a mask, with and
without the ReLU; the layer takes it without a group. The kernels themselves
are compared with a float64 plain version on the card
(``tests/test_torch_gpu.py``)."""

import pytest
import torch

from efficient_gnns_tpu_torch.models import MaskedBatchNorm
from efficient_gnns_tpu_torch.ops.cuda import masked_bn as M


def _seed_layer(bn, x, mask):
    """``MaskedBatchNorm.forward`` as the layer ran it before its kernels."""
    def stats():
        xf = x.float()
        if mask is not None:
            m = mask.float()[:, None]
            count, rows = m.sum(), (lambda t: t * m)
        else:
            count, rows = torch.tensor(float(x.shape[0]), device=x.device), (lambda t: t)
        s1 = rows(xf).sum(0)
        if bn.two_pass:
            count = count.clamp_min(1.0)
            mean = s1 / count
            dev = xf - mean
            return mean, rows(dev * dev).sum(0) / count
        s2 = rows(xf * xf).sum(0)
        count = count.clamp_min(1.0)
        mean = s1 / count
        return mean, (s2 / count - mean * mean).clamp_min(0.0)

    if bn.training:
        mean, var = stats()
        with torch.no_grad():
            bn.running_mean.mul_(bn.momentum).add_((1 - bn.momentum) * mean)
            bn.running_var.mul_(bn.momentum).add_((1 - bn.momentum) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    y = (x.float() - mean) * torch.rsqrt(var + bn.epsilon)
    return (y * bn.scale + bn.bias).to(x.dtype)


def _run(fn, bn, x, dy):
    xx = x.clone().requires_grad_(True)
    bn.zero_grad(set_to_none=True)
    y = fn(xx)
    y.backward(dy)
    return [y.detach(), xx.grad, bn.scale.grad, bn.bias.grad, bn.running_mean.clone(),
            bn.running_var.clone()]


def _layer(f, two_pass, training, seed=0):
    bn = MaskedBatchNorm(f, device="cpu", two_pass=two_pass)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.scale.copy_(1 + 0.5 * torch.randn(f, generator=g))
        bn.bias.copy_(0.3 * torch.randn(f, generator=g))
        bn.running_mean.copy_(torch.randn(f, generator=g))
        bn.running_var.copy_(1 + torch.rand(f, generator=g))
    return bn.train(training)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("two_pass", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_the_layer_on_the_cpu_is_its_seed_chain_bit_for_bit(training, two_pass, use_mask, relu):
    g = torch.Generator().manual_seed(1)
    n, f = 37, 11
    x = torch.randn(n, f, generator=g) * 3 + 1
    dy = torch.randn(n, f, generator=g)
    mask = (torch.arange(n) % 5 != 0) if use_mask else None
    bn = _layer(f, two_pass, training)
    got = _run(lambda t: bn(t, mask, relu=relu), bn, x, dy)
    bn_seed = _layer(f, two_pass, training)
    want = _run(lambda t: (torch.relu(_seed_layer(bn_seed, t, mask)) if relu
                           else _seed_layer(bn_seed, t, mask)), bn_seed, x, dy)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("training", [True, False])
def test_the_wrapper_on_the_cpu_is_the_plain_chain(training):
    """``masked_batch_norm`` on CPU tensors runs its plain version: the same
    bits, the running statistics stepped alike, no kernel counted."""
    g = torch.Generator().manual_seed(2)
    n, f = 50, 6
    x, mask = torch.randn(n, f, generator=g), torch.arange(n) < 41
    scale, bias = torch.rand(f, generator=g) + 0.5, torch.randn(f, generator=g)
    stats = [torch.randn(f, generator=g), torch.rand(f, generator=g) + 1]
    before = [k.launches for k in M.KERNELS]
    outs = []
    for fn in (M.masked_batch_norm, M.masked_batch_norm_plain):
        rm, rv = (t.clone() for t in stats)
        y = fn(x, mask, scale, bias, rm, rv, training=training, momentum=0.9, epsilon=1e-5,
               relu=True, two_pass=True)
        outs.append((y, rm, rv))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert [k.launches for k in M.KERNELS] == before


def test_the_wrapper_refuses_devices_without_kernels():
    x = torch.empty(4, 3, device="meta")
    args = [torch.empty(3, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        M.masked_batch_norm(x, None, *args, training=True, momentum=0.9, epsilon=1e-5)


@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("n,f", [(169343, 750), (169343, 256), (91445, 256), (2049, 300),
                                 (1280, 600), (32, 300), (5, 7), (0, 4)])
def test_the_chunks_cover_the_rows_once(n, f, vec):
    """The two-kernel and eval kernels' chunks of rows: every row in one
    chunk, no chunk empty (but the one of an empty input), at most one chunk
    a 128 rows, about ``CHUNK_CTAS`` CTAs."""
    chunks, rows = M.chunks_for(n, f, vec)
    assert chunks >= 1 and rows >= 1
    assert chunks * rows >= n and (chunks - 1) * rows < max(n, 1)
    assert chunks <= max(1, -(-n // 128))
    slices = -(-f // (M.LANES * vec))
    assert chunks * slices <= M.CHUNK_CTAS + slices


def test_a_thread_loads_as_many_columns_as_the_width_and_addresses_allow():
    assert [M.vec_for(torch.empty(3, f)) for f in (256, 600, 750, 300, 7, 13)] == [
        4, 4, 2, 4, 1, 1]
    shifted = torch.empty(1 + 4 * 250)[1:].view(4, 250)  # 4 bytes past an aligned start
    assert M.vec_for(shifted) == 1 and M.vec_for(torch.empty(4, 250)) == 2
    assert M.vec_for(torch.empty(4, 256), shifted.new_empty(8)[2:].view(2, 3)) == 2


def test_every_kernel_counts_its_launches():
    names = [k.__name__ for k in M.KERNELS]
    assert names == ["bn_fused", "bn_partials", "bn_apply", "bn_eval", "bn_grad_fused",
                     "bn_grad_partials", "bn_grad_apply"]
    assert all(isinstance(k.launches, int) for k in M.KERNELS)
    assert M.SMALL_ROWS == 2048
