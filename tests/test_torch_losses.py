"""GIoU, the Hungarian matcher and the Deformable DETR set loss of the
PyTorch port against the JAX package, on the CPU.

Tolerances. GIoU: ``atol 1e-6`` (the same f32 formula, other compilers).
Matcher: the selected columns must be EQUAL to JAX's, ties included (the
port repeats the float order of the row step, first-index argmin and the
valid-first stable row order), and the total cost equal to scipy's optimum
within f32 rounding. Set loss: sums within ``1e-5`` relative, gradients
within ``1e-5`` of each gradient's largest magnitude (f32 sums over the
(query, class) grid in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment
from torch.profiler import ProfilerActivity, profile

from tpudet.ops import boxes as jboxes
from tpudet.ops.hungarian import hungarian as jax_hungarian
from tpudet.ops.hungarian import hungarian_masked as jax_hungarian_masked
from tpudet.train import losses as jlosses
from tpudet_torch.ops import boxes as tboxes
from tpudet_torch.ops import hungarian as thung
from tpudet_torch.train import losses as tlosses

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.asarray(x))


def boxes(rng, n, degenerate=0):
    """xyxy boxes, overlapping, nested and disjoint; the first
    ``degenerate`` inverted (area 0)."""
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(0, 60, (n, 2))
    b = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    b[:degenerate, 2] = b[:degenerate, 0] - 2.0
    return b


# ----------------------------------------------------------------- GIoU
def test_elementwise_and_pairwise_giou_equal_jax():
    rng = np.random.default_rng(0)
    a, b = boxes(rng, 40, degenerate=3), boxes(rng, 40)
    b[5] = a[5]  # identical pair: GIoU 1
    ref = np.asarray(jboxes.elementwise_giou(jnp.asarray(a), jnp.asarray(b)))
    out = tboxes.elementwise_giou(t(a), t(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert ref.min() < -0.3 and ref[5] == pytest.approx(1.0)
    c = boxes(rng, 17)
    ref = np.asarray(jboxes.pairwise_giou(jnp.asarray(a), jnp.asarray(c)))
    out = tboxes.pairwise_giou(t(a), t(c))
    assert out.shape == (40, 17)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    # Leading axes: one pairwise GIoU per batch entry.
    batched = tboxes.pairwise_giou(t(np.stack([a, a[::-1]])),
                                   t(np.stack([c, c])))
    np.testing.assert_allclose(batched[1].numpy(), ref[::-1], rtol=0,
                               atol=1e-6)


def test_giou_gradient_equals_jax():
    rng = np.random.default_rng(1)
    a, b = boxes(rng, 30), boxes(rng, 30)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(
        jboxes.elementwise_giou(x, jnp.asarray(b)) * jnp.arange(30.0)))(
            jnp.asarray(a)))
    x = t(a).requires_grad_()
    (tboxes.elementwise_giou(x, t(b)) * torch.arange(30.0)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- matcher
_jax_masked = jax.jit(jax.vmap(jax_hungarian_masked))
_jax_full = jax.jit(jax.vmap(jax_hungarian))


def cost_case(kind, rng, problems, rows, cols):
    if kind == "continuous":
        return rng.normal(0, 1, (problems, rows, cols)).astype(np.float32)
    # Small integers: many exact ties among the columns.
    return rng.integers(0, 4, (problems, rows, cols)).astype(np.float32)


@pytest.mark.parametrize("kind", ["continuous", "integer ties"])
@pytest.mark.parametrize("rows,cols", [(7, 20), (12, 12), (1, 5), (20, 300)])
def test_hungarian_equals_jax_and_scipy(kind, rows, cols):
    rng = np.random.default_rng(rows * cols)
    cost = cost_case(kind, rng, 6, rows, cols)
    ref = np.asarray(_jax_full(jnp.asarray(cost)))
    out = thung.hungarian(t(cost))
    assert out.dtype == torch.int64 and out.shape == (6, rows)
    np.testing.assert_array_equal(out.numpy(), ref)
    for p in range(6):
        r, c = linear_sum_assignment(cost[p])
        assert len(set(out[p].tolist())) == rows
        assert cost[p][np.arange(rows), out[p].numpy()].sum() == pytest.approx(
            cost[p][r, c].sum(), abs=1e-4)


@pytest.mark.parametrize("kind", ["continuous", "integer ties"])
@pytest.mark.parametrize("rows,cols", [(10, 20), (8, 8), (20, 300)])
def test_hungarian_masked_equals_jax_and_scipy(kind, rows, cols):
    """Padded rows (zero cost, as the set loss pads them) take the sentinel
    ``C``; one problem has no valid row, one has all rows valid."""
    rng = np.random.default_rng(rows + cols)
    valid = rng.uniform(size=(6, rows)) < 0.6
    valid[0] = False
    valid[1] = True
    cost = cost_case(kind, rng, 6, rows, cols)
    cost = np.where(valid[..., None], cost, 0.0).astype(np.float32)
    ref = np.asarray(_jax_masked(jnp.asarray(cost), jnp.asarray(valid)))
    out = thung.hungarian_masked(t(cost), t(valid))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out.numpy()[~valid] == cols).all()
    for p in range(6):
        sub = cost[p][valid[p]]
        if not len(sub):
            continue
        r, c = linear_sum_assignment(sub)
        got = out[p].numpy()[valid[p]]
        assert sub[np.arange(len(sub)), got].sum() == pytest.approx(
            sub[r, c].sum(), abs=1e-4)


def test_hungarian_leading_axes_and_timing():
    rng = np.random.default_rng(3)
    cost = rng.normal(0, 1, (2, 3, 5, 9)).astype(np.float32)
    valid = rng.uniform(size=(2, 3, 5)) < 0.7
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = thung.hungarian_masked(t(cost), t(valid))
    assert out.shape == (2, 3, 5)
    # The call is one matcher span, its copies to the host a child span.
    spans = [e for e in prof.events() if e.name.startswith("tpudet/")]
    assert [e.name for e in spans] == ["tpudet/matcher",
                                       "tpudet/matcher/fetch"]
    matcher, fetch = spans
    assert fetch.cpu_parent is matcher and matcher.cpu_time_total > 0
    flat = thung.hungarian_masked(t(cost.reshape(6, 5, 9)),
                                  t(valid.reshape(6, 5)))
    assert torch.equal(out.reshape(6, 5), flat)
    with pytest.raises(ValueError, match="rows <= cols"):
        thung.hungarian(t(cost.transpose(0, 1, 3, 2)))


# -------------------------------------------------------------- set loss
COSTS = dict(cost_class=2.0, cost_bbox=5.0, cost_giou=2.0, alpha=0.25,
             gamma=2.0)


def set_loss_case(seed, layers=3, b=2, q=20, c=4, g=6):
    """Logits and boxes per (layer, image), ground truth padded to ``g``
    rows with 0..g valid per image, classes 1..c; one padded row carries a
    class of 0 and one a class above ``c``, as padding may."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(-1, 2, (layers, b, q, c)).astype(np.float32)
    cxcy = rng.uniform(0.1, 0.9, (layers, b, q, 2))
    wh = rng.uniform(0.05, 0.5, (layers, b, q, 2))
    pred = np.concatenate([cxcy, wh], -1).astype(np.float32)
    gt = np.concatenate([rng.uniform(0.1, 0.9, (b, g, 2)),
                         rng.uniform(0.05, 0.5, (b, g, 2))], -1)
    classes = rng.integers(1, c + 1, (b, g)).astype(np.int32)
    valid = np.zeros((b, g), bool)
    valid[0, :4] = True
    valid[1, :g] = True
    gt[0, 4:] = 0.0
    classes[0, 4], classes[0, 5] = 0, c + 3
    return logits, pred, gt.astype(np.float32), classes, valid


def jax_set_loss(logits, pred, gt, classes, valid):
    per_image = jax.vmap(
        lambda lg, pb, gb, gc, gv: jlosses.deformable_detr_set_loss(
            lg, pb, gb, gc, gv, **COSTS))
    return jax.vmap(per_image, in_axes=(0, 0, None, None, None))(
        logits, pred, gt, classes, valid)


@pytest.mark.parametrize("seed", [0, 1])
def test_set_loss_sums_and_gradients_equal_jax(seed):
    logits, pred, gt, classes, valid = set_loss_case(seed)
    args = tuple(jnp.asarray(x) for x in (logits, pred, gt, classes, valid))
    ref = [np.asarray(x) for x in jax.jit(jax_set_loss)(*args)]
    weights = np.array([2.0, 5.0, 2.0], np.float32)

    def jax_total(lg, pb):
        f, l1, gi, _ = jax_set_loss(lg, pb, *args[2:])
        return jnp.sum(f) * 2.0 + jnp.sum(l1) * 5.0 + jnp.sum(gi) * 2.0

    ref_gl, ref_gb = (np.asarray(x) for x in jax.jit(
        jax.grad(jax_total, argnums=(0, 1)))(args[0], args[1]))

    lg = t(logits).requires_grad_()
    pb = t(pred).requires_grad_()
    layers = logits.shape[0]
    out = tlosses.deformable_detr_set_loss(
        lg, pb, t(gt).expand(layers, -1, -1, -1),
        t(classes).expand(layers, -1, -1), t(valid).expand(layers, -1, -1),
        **COSTS)
    for got, want in zip(out, ref):
        assert got.shape == want.shape == (layers, 2)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    total = sum(w * o.sum() for w, o in zip(weights, out[:3]))
    total.backward()
    for got, want in ((lg.grad, ref_gl), (pb.grad, ref_gb)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert np.abs(ref_gb).max() > 0.1


def test_set_loss_matches_equal_jax_and_sentinel_handling():
    """The matched queries equal JAX's; no valid row leaves only the
    background focal term; the padded rows' classes never reach it."""
    logits, pred, gt, classes, valid = set_loss_case(5, layers=1)
    cost_seen = []
    original = tlosses.hungarian_masked

    def recording(cost, row_valid):
        cost_seen.append(original(cost, row_valid))
        return cost_seen[-1]

    tlosses.hungarian_masked = recording
    try:
        tlosses.deformable_detr_set_loss(
            t(logits), t(pred), t(gt)[None], t(classes)[None], t(valid)[None],
            **COSTS)
    finally:
        tlosses.hungarian_masked = original
    # JAX's matcher on the cost JAX's set loss builds.
    @jax.jit
    def jax_match(lg, gb, pr, gc, gv):
        p = jax.nn.sigmoid(lg)
        pos = 0.25 * (1 - p) ** 2 * -jnp.log(p + 1e-8)
        neg = 0.75 * p ** 2 * -jnp.log(1 - p + 1e-8)
        col = jnp.clip(gc - 1, 0, lg.shape[-1] - 1)
        cost = (2.0 * (pos - neg)[:, col].T
                + 5.0 * jnp.sum(jnp.abs(gb[:, None] - pr[None]), -1)
                - 2.0 * jboxes.pairwise_giou(jboxes.cxcywh_to_xyxy(gb),
                                             jboxes.cxcywh_to_xyxy(pr)))
        cost = jnp.where(gv[:, None], cost, 0.0)
        return jax_hungarian_masked(cost, gv)

    ref = [np.asarray(jax_match(*(jnp.asarray(x) for x in (
        logits[0, i], gt[i], pred[0, i], classes[i], valid[i]))))
        for i in range(2)]
    np.testing.assert_array_equal(cost_seen[0][0].numpy(), np.stack(ref))
    none = np.zeros_like(valid)
    f, l1, gi, npos = tlosses.deformable_detr_set_loss(
        t(logits), t(pred), t(gt)[None], t(classes)[None], t(none)[None],
        **COSTS)
    jf = jax.jit(jax_set_loss)(*(jnp.asarray(x) for x in (
        logits, pred, gt, classes, none)))[0]
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5)
    assert (l1 == 0).all() and (gi == 0).all() and (npos == 0).all()
