"""Port vs JAX: every distillation criterion term.

The same NumPy inputs go through ``efficient_gnns_tpu.distill.criteria`` and
the port's ``distill/criteria.py``; values must agree to rtol 1e-5 and
gradients with respect to the student features to rtol 1e-4 (float32; the
difference is the summation order of the reductions and matmuls). The
subsampled terms draw their rows from ``jax.random`` on one side and a
``torch.Generator`` on the other (same distribution, other bits), so the
tests compute the rows with the JAX ``subsample_rows`` and hand them to the
port as ``idx`` / ``sel_mask``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu.distill import criteria as jc
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu_torch.distill import criteria as tc
from efficient_gnns_tpu_torch.graphs import build_graph
from efficient_gnns_tpu_torch.ops.segment import segment_softmax
from efficient_gnns_tpu_torch.ops.sorted_segment import csr_segment_softmax

N, C, D, DT = 60, 7, 12, 20
KERNELS = ["cosine", "poly", "l2", "rbf"]


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.fixture
def data(rng):
    feat = rng.normal(size=(N, D)).astype(np.float32)
    feat[3] = 0.0  # an all-zero (post-ReLU) row: the normalisation stays finite
    return dict(
        logits=(rng.normal(size=(N, C)) * 3).astype(np.float32),
        teacher_logits=(rng.normal(size=(N, C)) * 3).astype(np.float32),
        labels=rng.integers(0, C, size=N),
        targets=(rng.random((N, C)) < 0.3).astype(np.float32),
        feat=feat,
        teacher_feat=rng.normal(size=(N, D)).astype(np.float32),
        mask=rng.random(N) < 0.7,
    )


def _close(got, want, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


SIMPLE = {
    "cls_bce": ("logits", "targets"),
    "kd_term_bce": ("logits", "teacher_logits"),
    "kd_criterion_bce": ("logits", "targets", "teacher_logits"),
    "fitnet_term": ("feat", "teacher_feat"),
    "fitnet_criterion": ("logits", "labels", "feat", "teacher_feat"),
    "at_term": ("feat", "teacher_feat"),
    "at_criterion": ("logits", "labels", "feat", "teacher_feat"),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(SIMPLE))
def test_elementwise_terms_match_jax(data, name, masked):
    args = [data[k] for k in SIMPLE[name]]
    mask = data["mask"] if masked else None
    want = getattr(jc, name)(*map(_j, args), mask=_j(mask))
    got = getattr(tc, name)(*map(_t, args), mask=_t(mask))
    if name.endswith("criterion") or name.endswith("criterion_bce"):
        assert len(got) == 3
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def _rows(sampling, mask, n=N, m=24, seed=5):
    """(mask handed to the term, idx, sel_mask) for one sampling case, the
    rows drawn by the JAX package's subsample_rows."""
    if sampling == "all":
        return None, None, None
    if sampling == "mask_only":  # no key / generator: the mask alone
        return mask, None, None
    use_mask = mask if sampling == "idx_masked" else None
    idx, sel = jc.subsample_rows(jax.random.PRNGKey(seed), n, m, _j(use_mask))
    return use_mask, np.asarray(idx), None if sel is None else np.asarray(sel)


SAMPLINGS = ["all", "mask_only", "idx", "idx_masked"]


def _jax_sampled(fn, sampling, mask, *args, **kw):
    """The JAX term, sampling inside it with the key that ``_rows`` uses."""
    if sampling in ("idx", "idx_masked"):
        kw.update(key=jax.random.PRNGKey(5), max_samples=24)
    return fn(*args, mask=_j(mask), **kw)


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_gsp_term_matches_jax(data, kernel, sampling):
    mask, idx, sel = _rows(sampling, data["mask"])
    want = _jax_sampled(jc.gsp_term, sampling, mask, _j(data["feat"]),
                        _j(data["teacher_feat"]), kernel)
    got = tc.gsp_term(_t(data["feat"]), _t(data["teacher_feat"]), kernel,
                      mask=_t(mask), idx=_t(idx), sel_mask=_t(sel))
    _close(got, want)


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_nce_term_matches_jax(data, sampling):
    mask, idx, sel = _rows(sampling, data["mask"])
    want = _jax_sampled(jc.nce_term, sampling, mask, _j(data["feat"]),
                        _j(data["teacher_feat"]), 0.1)
    got = tc.nce_term(_t(data["feat"]), _t(data["teacher_feat"]), 0.1,
                      mask=_t(mask), idx=_t(idx), sel_mask=_t(sel))
    _close(got, want)


def _graph_pair(rng, n=N, e=200):
    s = rng.integers(0, n, size=e)
    r = rng.integers(0, n - 8, size=e)  # the last rows receive nothing
    r[: e // 4] = 2  # a receiver of high degree
    kw = dict(edge_pad_multiple=64)
    jg, tg = jax_build_graph(s, r, n, **kw), build_graph(s, r, n, **kw)
    assert tg.n_edge < tg.num_edges_padded  # padding edges, clamped and masked
    return jg, tg


@pytest.mark.parametrize("sampling", ["all", "idx_masked"])
@pytest.mark.parametrize("positives", ["labels", "edges", "labels-edges"])
def test_nce_term_structured_matches_jax(rng, data, positives, sampling):
    jg, tg = _graph_pair(rng)
    mask, idx, sel = _rows(sampling, data["mask"])
    labels = data["labels"] if "labels" in positives else None
    jkw = dict(labels=_j(labels), graph=jg if "edges" in positives else None)
    tkw = dict(labels=_t(labels), graph=tg if "edges" in positives else None)
    want = _jax_sampled(jc.nce_term_structured, sampling, mask, _j(data["feat"]),
                        _j(data["teacher_feat"]), 0.1, **jkw)
    got = tc.nce_term_structured(_t(data["feat"]), _t(data["teacher_feat"]), 0.1,
                                 mask=_t(mask), idx=_t(idx), sel_mask=_t(sel), **tkw)
    _close(got, want)
    if positives == "edges" and sampling == "all":
        # the edges add positives: the loss differs from the plain diagonal one
        plain = tc.nce_term(_t(data["feat"]), _t(data["teacher_feat"]), 0.1)
        assert abs(got.item() - plain.item()) > 1e-3


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("mode", ["kld", "mse"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_lsp_term_matches_jax(rng, data, kernel, mode, keep):
    jg, tg = _graph_pair(rng)
    keep_mask = rng.random(tg.num_edges_padded) < 0.6 if keep else None
    want = jc.lsp_term(jg, _j(data["feat"]), _j(data["teacher_feat"]), kernel, mode,
                       _j(keep_mask))
    got = tc.lsp_term(tg, _t(data["feat"]), _t(data["teacher_feat"]), kernel, mode,
                      _t(keep_mask))
    _close(got, want)


@pytest.mark.parametrize("keep", [False, True])
def test_csr_segment_softmax_is_segment_softmax(rng, keep):
    """``lsp_term``'s softmax, its sums on K1 in CSR order (the plain
    version here), gives ``segment_softmax``'s bits and its gradient."""
    _, tg = _graph_pair(rng)
    mask = tg.edge_mask
    if keep:
        mask = mask & _t(rng.random(tg.num_edges_padded) < 0.6)
    logits = rng.normal(size=tg.num_edges_padded).astype(np.float32) * 3
    cot = _t(rng.normal(size=tg.num_edges_padded).astype(np.float32))
    ident = torch.arange(tg.num_edges_padded, dtype=torch.int32)
    got, want = (torch.tensor(logits, requires_grad=True) for _ in range(2))
    p = csr_segment_softmax(got, tg.receivers, tg.row_offsets, tg.row_split, ident, mask)
    q = segment_softmax(want, tg.receivers, tg.num_nodes, mask)
    (p * cot).sum().backward()
    (q * cot).sum().backward()
    assert torch.equal(p, q) and bool(p[~mask].eq(0).all())
    _close(got.grad, want.grad, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["gsp_criterion", "nce_criterion", "lsp_criterion"])
def test_sampled_criteria_match_jax(rng, data, name):
    args = [data[k] for k in ("logits", "labels", "feat", "teacher_feat")]
    jextra, textra = [], []
    if name == "lsp_criterion":
        jextra, textra = _graph_pair(rng)
        jextra, textra = [jextra], [textra]
    want = getattr(jc, name)(*map(_j, args), *jextra)
    got = getattr(tc, name)(*map(_t, args), *textra)
    for g, w in zip(got, want):
        _close(g, w)


GRAD_TERMS = {
    "fitnet": lambda m, f, t, g: m.fitnet_term(f, t),
    "at": lambda m, f, t, g: m.at_term(f, t),
    "gsp-l2": lambda m, f, t, g: m.gsp_term(f, t, "l2"),
    "gsp-rbf": lambda m, f, t, g: m.gsp_term(f, t, "rbf"),
    "lsp-cosine": lambda m, f, t, g: m.lsp_term(g, f, t, "cosine"),
    "lsp-l2-mse": lambda m, f, t, g: m.lsp_term(g, f, t, "l2", "mse"),
    "lsp-poly": lambda m, f, t, g: m.lsp_term(g, f, t, "poly"),
    "nce": lambda m, f, t, g: m.nce_term(f, t, 0.1),
    "nce-edges": lambda m, f, t, g: m.nce_term_structured(f, t, 0.1, graph=g),
}


@pytest.mark.parametrize("name", sorted(GRAD_TERMS))
def test_term_gradients_match_jax(rng, data, name):
    jg, tg = _graph_pair(rng)
    fn = GRAD_TERMS[name]
    want = jax.grad(lambda f: fn(jc, f, _j(data["teacher_feat"]), jg))(_j(data["feat"]))
    feat = torch.tensor(data["feat"], requires_grad=True)
    fn(tc, feat, _t(data["teacher_feat"]), tg).backward()
    assert torch.isfinite(feat.grad).all()  # the all-zero row included
    scale = float(np.abs(np.asarray(want)).max())
    _close(feat.grad, want, rtol=1e-4, atol=1e-5 * scale)


def test_fully_masked_rows_stay_finite(data):
    # every candidate masked: the finite fill (a where, not a multiply) keeps
    # log_softmax finite and the masked rows contribute 0
    none = np.zeros(N, bool)
    for fn in (tc.nce_term, tc.nce_term_structured):
        feat = torch.tensor(data["feat"], requires_grad=True)
        got = fn(feat, _t(data["teacher_feat"]), 0.1, mask=_t(none))
        got.backward()
        assert got.item() == 0.0 and torch.isfinite(feat.grad).all()
    want = jc.nce_term(_j(data["feat"]), _j(data["teacher_feat"]), 0.1, mask=_j(none))
    assert float(want) == 0.0


def test_subsample_rows_draws_from_the_generator(data):
    mask = _t(data["mask"])
    gen = torch.Generator().manual_seed(3)
    idx, sel = tc.subsample_rows(gen, N, 24, mask)
    again, _ = tc.subsample_rows(torch.Generator().manual_seed(3), N, 24, mask)
    other, _ = tc.subsample_rows(torch.Generator().manual_seed(4), N, 24, mask)
    assert torch.equal(idx, again) and not torch.equal(idx, other)
    assert idx.shape == (24,) and idx.unique().numel() == 24
    assert sel.all() and mask[idx].all()  # valid rows sort first
    # fewer valid rows than samples: the padding rows come last, flagged
    few = torch.zeros(N, dtype=torch.bool)
    few[:10] = True
    idx, sel = tc.subsample_rows(gen, N, 24, few)
    assert sel[:10].all() and not sel[10:].any() and set(idx[:10].tolist()) == set(range(10))
    # nothing to draw: every row, in order, as the JAX package
    idx, sel = tc.subsample_rows(gen, N, N, None)
    assert torch.equal(idx, torch.arange(N)) and sel is None
    jidx, jsel = jc.subsample_rows(jax.random.PRNGKey(0), N, N, None)
    assert np.array_equal(np.asarray(jidx), idx.numpy()) and jsel is None
    # a term with a generator samples; the same seed gives the same loss
    f, t = _t(data["feat"]), _t(data["teacher_feat"])
    a = tc.nce_term(f, t, 0.1, generator=torch.Generator().manual_seed(1), max_samples=16)
    b = tc.nce_term(f, t, 0.1, generator=torch.Generator().manual_seed(1), max_samples=16)
    c = tc.nce_term(f, t, 0.1, generator=torch.Generator().manual_seed(2), max_samples=16)
    assert a.item() == b.item() != c.item()


@pytest.mark.parametrize("term", ["gsp_term", "nce_term", "nce_term_structured"])
def test_sampled_term_refuses_more_rows_than_max_samples_without_a_draw(data, term):
    """No generator and no idx: all rows would go into one n x n matrix."""
    f, t = _t(data["feat"]), _t(data["teacher_feat"])
    fn = getattr(tc, term)
    with pytest.raises(ValueError, match="max_samples"):
        fn(f, t, max_samples=N - 1)
    assert torch.isfinite(fn(f, t, max_samples=N))  # all rows fit: no draw needed
    assert torch.isfinite(fn(f, t, max_samples=N - 1, idx=torch.arange(N - 1)))
