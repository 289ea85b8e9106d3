"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a card. On a
machine with one (and without JAX, which ``tests/conftest.py`` imports):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Shapes here are small and ragged (box counts that are not a multiple of the
64-box block, channel counts that are not a multiple of 32); ``chip_smoke.py``
covers the main paths' shapes.
"""

import math

import pytest
import torch

from tpudet_torch import kernels as tk
from tpudet_torch.kernels import deform_attn as kda
from tpudet_torch.kernels import frozen_bn as kfb
from tpudet_torch.kernels import nms as knms
from tpudet_torch.kernels import roi_align as kra
from tpudet_torch.kernels import roi_align_window as krw
from tpudet_torch.models.layers import FrozenBatchNorm
from tpudet_torch.models.resnet import Bottleneck, ResNet
from tpudet_torch.ops import nms as tnms
from tpudet_torch.ops.roi_align import fpn_assign_levels

from tests.test_torch_frozen_bn import drawn_norm, module_by_module

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def boxes(gen, b, n, extent=300.0):
    xy = torch.rand(b, n, 2, generator=gen) * extent
    wh = 4 + torch.rand(b, n, 2, generator=gen) * 80
    return torch.cat([xy, xy + wh], dim=-1)


@pytest.mark.parametrize("b,n,thr,k", [(1, 1, 0.5, 4), (3, 65, 0.5, 10),
                                       (2, 700, 0.7, 300), (4, 130, 0.3, 200)])
def test_nms_kernel_equals_plain(cuda, b, n, thr, k):
    gen = torch.Generator().manual_seed(n)
    bx = boxes(gen, b, n)
    cand = torch.rand(b, n, generator=gen) > 0.1
    out = knms.nms_keep_cuda(bx.to(cuda), cand.to(cuda), thr, k)
    ref = knms.nms_keep_plain(bx, cand, thr, k)
    assert torch.equal(out[0].cpu(), ref[0])
    assert torch.equal(out[1].cpu(), ref[1])


def sparse_boxes(gen, b, n, extent):
    """Small boxes over a wide field: few overlap, so the walk keeps most."""
    xy = torch.rand(b, n, 2, generator=gen) * extent
    return torch.cat([xy, xy + 2 + torch.rand(b, n, 2, generator=gen) * 6],
                     dim=-1)


@pytest.mark.parametrize("case", ["max_out inside a block", "ragged P",
                                  "diagonal words above 48 KB",
                                  "all masked", "max_out above the keeps",
                                  "kept list above 48 KB"])
def test_nms_kernel_walk_edges(cuda, case):
    """Where the step-at-a-time walk turns: the max_out-th keep inside a
    step, a last step of 13 boxes, 6,500 boxes (26 steps; their diagonal
    words take 203 KB), no candidate, fewer keeps than max_out, and 20,000
    keeps (each of the cluster's blocks holds 2,500 kept boxes, 50 KB of
    shared memory: past the 48 KB a block takes without an opt-in)."""
    gen = torch.Generator().manual_seed(31)
    b, n, thr, k = {"max_out inside a block": (3, 300, 0.5, 70),
                    "ragged P": (2, 1000 + 37, 0.5, 1037),
                    "diagonal words above 48 KB": (2, 6500, 0.7, 2000),
                    "all masked": (2, 200, 0.5, 50),
                    "max_out above the keeps": (2, 150, 0.3, 400),
                    "kept list above 48 KB": (1, 20000, 0.5, 20000)}[case]
    if case == "max_out inside a block":
        bx = sparse_boxes(gen, b, n, 2000.0)
    elif case == "kept list above 48 KB":
        bx = sparse_boxes(gen, b, n, 40000.0)
    elif case == "diagonal words above 48 KB":  # jittered copies of 40 boxes
        base = boxes(gen, b, 40)
        pick = torch.randint(0, 40, (b, n), generator=gen)
        bx = (torch.gather(base, 1, pick[..., None].expand(-1, -1, 4))
              + torch.randn(b, n, 4, generator=gen) * 3)
    else:
        bx = boxes(gen, b, n)
    cand = torch.rand(b, n, generator=gen) > 0.1
    if case == "all masked":
        cand[:] = False
    elif case == "kept list above 48 KB":
        cand[:] = True
    out = knms.nms_keep_cuda(bx.to(cuda), cand.to(cuda), thr, k)
    ref = knms.nms_keep_plain(bx, cand, thr, k)
    assert torch.equal(out[0].cpu(), ref[0])
    assert torch.equal(out[1].cpu(), ref[1])
    kept = ref[1].sum(dim=1)
    if case == "max_out inside a block":
        last = ref[0][:, k - 1]
        assert (kept == k).all() and (last % 64 != 63).all()
    elif case == "diagonal words above 48 KB":
        # The walk crosses most of the 102 blocks.
        assert (ref[0].max(dim=1).values > 4000).all()
    elif case == "all masked":
        assert (kept == 0).all() and (out[0] == 0).all()
    elif case == "max_out above the keeps":
        assert (kept < n).all() and (kept > 0).all()
    elif case == "kept list above 48 KB":
        assert (kept > 19500).all()  # > 2,437 boxes (48.7 KB) per block


def test_nms_dispatch_on_card_equals_cpu(cuda):
    gen = torch.Generator().manual_seed(7)
    bx = boxes(gen, 2, 300)
    scores = torch.rand(2, 300, generator=gen)
    scores[0, 5] = float("nan")
    classes = torch.randint(1, 4, (2, 300), generator=gen)
    mask = scores > 0.05
    for fn, args in ((tk.nms_dispatch, (bx, scores)),
                     (tk.batched_nms_dispatch, (bx, scores, classes))):
        ref = fn(*args, 0.5, 50, valid_mask=mask)
        out = fn(*(a.to(cuda) for a in args), 0.5, 50,
                 valid_mask=mask.to(cuda))
        assert torch.equal(out[0].cpu(), ref[0])
        assert torch.equal(out[1].cpu(), ref[1])
    ref = tnms.nms(bx, scores, 0.5, 50, score_threshold=0.3)
    out = tk.nms_dispatch(bx.to(cuda), scores.to(cuda), 0.5, 50,
                          score_threshold=0.3)
    assert torch.equal(out[0].cpu(), ref[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,s,r", [(40, 7, 2), (256, 5, 3), (8, 1, 1)])
def test_roi_align_kernel_equals_plain(cuda, dtype, c, s, r):
    gen = torch.Generator().manual_seed(c)
    feat = torch.randn(3, 11, 19, c, generator=gen).to(dtype)
    rois = boxes(gen, 3, 9, extent=18.0).reshape(-1, 4) / 4 - 1
    rois[0] = torch.tensor([3.0, 4.0, 3.0, 9.0])  # zero width
    index = torch.arange(3, dtype=torch.int32).repeat_interleave(9)
    out = kra.roi_align_cuda(feat.to(cuda), rois.to(cuda), index.to(cuda),
                             s, r).cpu().float()
    ref = kra.roi_align_plain(feat.to(cuda), rois.to(cuda), index.to(cuda),
                              s, r).cpu().float()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:  # one rounding of the same f32 sum: at most one bf16 ulp apart
        assert ((out - ref).abs() <= 2 ** -7 * ref.abs() + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [40, 256])
def test_roi_align_window_kernel_equals_plain(cuda, dtype, c):
    """A 4-level pyramid of a 104 x 168 canvas, 3 images x 7 RoIs with
    fit-bumped levels, a sliver and a RoI whose level names no map."""
    gen = torch.Generator().manual_seed(c)
    feats = [torch.randn(3, h, w, c, generator=gen).to(dtype)
             for h, w in ((26, 42), (13, 21), (7, 11), (4, 6))]
    rois = boxes(gen, 3, 7, extent=100.0)
    rois[0, 0] = torch.tensor([3.0, 4.0, 5.0, 100.0])  # a sliver
    levels = fpn_assign_levels(rois, fit_window=24) - 2
    levels[1, 2] = 7
    args = ([f.to(cuda) for f in feats], (4.0, 8.0, 16.0, 32.0),
            rois.to(cuda), levels.to(cuda), 7, 2)
    out = krw.roi_align_window_cuda(*args).cpu().float()
    ref = krw.roi_align_window_plain(*args).cpu().float()
    assert (out[1, 2] == 0).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:  # one rounding of the same f32 sum: at most one bf16 ulp apart
        assert ((out - ref).abs() <= 2 ** -7 * ref.abs() + 1e-6).all()


# The forward kernels' paths besides the 16-byte one at R = 2: a C that
# 16-byte vectors do not divide and a map whose base is not 16-byte aligned
# (one channel per lane), S * R past a warp's 32 lanes (S = 14, r = 3), and
# RoIs of zero width or off the map.
EDGE_CASES = ("C not a multiple of 16 bytes", "base not 16-byte aligned",
              "S * R > 32", "zero-width and off-map RoIs")


def edge_shape(case, dtype):
    """(C, S, r, storage offset of the features, 16-byte path expected)."""
    c = 64
    if case == EDGE_CASES[0]:
        c = 12 if dtype == torch.bfloat16 else 6
    s, r = (14, 3) if case == EDGE_CASES[2] else (7, 2)
    offset = 1 if case == EDGE_CASES[1] else 0
    return c, s, r, offset, case not in EDGE_CASES[:2]


def card_map(gen, shape, dtype, offset, cuda):
    """A contiguous tensor of ``shape`` (a [B, H, W, C] map, or a
    cotangent) on the card starting ``offset`` elements into its
    storage."""
    n = offset + torch.Size(shape).numel()
    flat = torch.randn(n, generator=gen).to(dtype).to(cuda)
    return flat[offset:].view(shape)


def assert_pooled_close(out, ref, dtype):
    out, ref = out.cpu().float(), ref.cpu().float()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:  # one rounding of the same f32 sum: at most one bf16 ulp apart
        assert ((out - ref).abs() <= 2 ** -7 * ref.abs() + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_roi_align_kernel_edge_paths(cuda, dtype, case):
    c, s, r, offset, vec = edge_shape(case, dtype)
    gen = torch.Generator().manual_seed(5)
    feat = card_map(gen, (3, 11, 19, c), dtype, offset, cuda)
    rois = boxes(gen, 3, 12, extent=18.0).reshape(-1, 4) / 4 - 1
    rois[0] = torch.tensor([3.0, 4.0, 3.0, 9.0])  # zero width
    off = [1]
    if case == EDGE_CASES[3]:
        rois[::3, 2] = rois[::3, 0]  # a third of zero width
        off = [1, 5, 8, 10]
        rois[off] = torch.tensor([[-9.0, -8.0, -2.0, -1.5],
                                  [20.5, 2.0, 30.0, 6.0],
                                  [3.0, 11.5, 9.0, 14.0],
                                  [-7.0, 12.0, -1.5, 30.0]])
    else:
        rois[1] = torch.tensor([-9.0, -8.0, -2.0, -1.5])
    rois = rois.to(cuda)
    index = torch.arange(3, dtype=torch.int32).repeat_interleave(12).to(cuda)
    assert kra.vectorized(torch.empty(1, c, dtype=dtype, device=cuda),
                          feat) == vec
    out = kra.roi_align_cuda(feat, rois, index, s, r)
    ref = kra.roi_align_plain(feat, rois, index, s, r)
    assert out.shape == (36, s, s, c)
    assert_pooled_close(out, ref, dtype)
    assert (out[off] == 0).all() and (out != 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_roi_align_window_kernel_edge_paths(cuda, dtype, case):
    """The same paths in the FPN kernel, with RoIs on all four levels and
    on levels outside the table (-1 and 4), which pool to zeros; in the
    unaligned case only the second level's map is unaligned."""
    c, s, r, offset, vec = edge_shape(case, dtype)
    gen = torch.Generator().manual_seed(6)
    feats = [card_map(gen, (3, h, w, c), dtype, offset if i == 1 else 0, cuda)
             for i, (h, w) in enumerate(((26, 42), (13, 21), (7, 11), (4, 6)))]
    # Levels -1, 0, 1, 2, 3, 4 by turns.
    levels = (torch.arange(36, dtype=torch.int32) % 6 - 1).reshape(3, 12)
    rois = boxes(gen, 3, 12, extent=100.0)
    rois[0, 2] = torch.tensor([3.0, 4.0, 3.0, 60.0])  # zero width, level 1
    off = [(0, 1)]  # off the map at level 0
    rois[0, 1] = torch.tensor([-90.0, -80.0, -20.0, -15.0])
    if case == EDGE_CASES[3]:
        rois[:, ::3, 2] = rois[:, ::3, 0]
        off += [(1, 4), (2, 7)]  # levels 3 and 0
        rois[1, 4] = torch.tensor([500.0, 500.0, 600.0, 560.0])
        rois[2, 7] = torch.tensor([-300.0, 10.0, -200.0, 40.0])
    args = (feats, (4.0, 8.0, 16.0, 32.0), rois.to(cuda), levels.to(cuda), s,
            r)
    assert krw.vectorized(torch.empty(1, c, dtype=dtype, device=cuda),
                          *feats) == vec
    out = krw.roi_align_window_cuda(*args)
    ref = krw.roi_align_window_plain(*args)
    assert out.shape == (3, 12, s, s, c)
    assert_pooled_close(out, ref, dtype)
    outside = (levels < 0) | (levels > 3)
    assert (out[outside.to(cuda)] == 0).all()
    assert all((out[i, j] == 0).all() for i, j in off)
    assert all((out[levels.to(cuda) == lv] != 0).any() for lv in range(4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,s,r", [(40, 7, 2), (256, 5, 3), (8, 1, 1)])
def test_roi_align_backward_kernel_equals_plain_autograd(cuda, dtype, c, s, r):
    """The features' gradient through the autograd Function (forward and
    backward kernels) against autograd through the plain version on the
    same card: RoIs across the border, off the map and of zero width."""
    gen = torch.Generator().manual_seed(c + 1)
    feat = torch.randn(3, 11, 19, c, generator=gen).to(dtype).to(cuda)
    rois = boxes(gen, 3, 9, extent=18.0).reshape(-1, 4) / 4 - 1
    rois[0] = torch.tensor([3.0, 4.0, 3.0, 9.0])  # zero width
    rois[1] = torch.tensor([-9.0, -8.0, -2.0, -1.5])  # off the map
    rois = rois.to(cuda)
    index = torch.arange(3, dtype=torch.int32).repeat_interleave(9).to(cuda)
    cot = torch.randn(27, s, s, c, generator=gen).to(dtype).to(cuda)
    before = kra.BACKWARD_LAUNCHES
    f = feat.clone().requires_grad_()
    (got,) = torch.autograd.grad(kra.roi_align(f, rois, index, s, r), f, cot)
    assert kra.BACKWARD_LAUNCHES == before + 1 and got.dtype == dtype
    f32 = feat.float().requires_grad_()
    (ref,) = torch.autograd.grad(kra.roi_align_plain(f32, rois, index, s, r),
                                 f32, cot.float())
    got = got.float()
    if dtype == torch.float32:  # f32 atomics in another order
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    else:  # one rounding of the same f32 sum: at most one bf16 ulp apart
        assert ((got - ref).abs() <= 2 ** -8 * ref.abs() + 1e-5).all()
    assert ref.abs().max() > 0


# The backward kernels' paths: those of the forwards, and many RoIs on a
# few cells (their atomics contend).
BACKWARD_CASES = EDGE_CASES + ("many RoIs on one cell",)


def backward_shape(case, dtype):
    """(C, S, r, storage offset of the cotangent, 16-byte path expected)."""
    if case in EDGE_CASES:
        return edge_shape(case, dtype)
    return 64, 7, 2, 0, True


def assert_gradient_close(got, ref, dtype, terms):
    """Against the f32 sum of autograd through the plain version: within
    1e-5 plus 2^-20 (a few f32 roundings) of the sum of the magnitudes of
    the terms each cell adds (``terms``: autograd's gradient for the
    cotangent's magnitudes, the bilinear weights being non-negative).
    Where hundreds of terms meet on a cell (S = 14 at r = 3, many RoIs on
    one cell), two f32 summation orders part by more than 1e-5 alone
    (1.24e-5 measured on the card); a lost or doubled atomic would move a
    cell by a whole term."""
    got, ref = got.cpu().float(), ref.cpu().float()
    slack = 1e-5 + 2 ** -20 * terms.cpu().float()
    if dtype == torch.float32:  # f32 atomics in another order
        assert ((got - ref).abs() <= slack).all(), (got - ref).abs().max()
    else:  # one rounding of the same f32 sum: at most one bf16 ulp apart
        assert ((got - ref).abs() <= 2 ** -8 * ref.abs() + slack).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_roi_align_backward_kernel_edge_paths(cuda, dtype, case):
    """The redesigned backward through the autograd Function and through
    its wrapper with the cotangent as given (in the unaligned case its base
    is off a 16-byte boundary), against autograd through the plain version
    on f32-widened features; each call one launch."""
    c, s, r, offset, vec = backward_shape(case, dtype)
    gen = torch.Generator().manual_seed(8)
    feat = torch.randn(3, 11, 19, c, generator=gen).to(dtype).to(cuda)
    rois = boxes(gen, 3, 12, extent=18.0).reshape(-1, 4) / 4 - 1
    rois[0] = torch.tensor([3.0, 4.0, 3.0, 9.0])  # zero width
    rois[1] = torch.tensor([-9.0, -8.0, -2.0, -1.5])  # off the map
    index = torch.arange(3, dtype=torch.int32).repeat_interleave(12)
    if case == EDGE_CASES[3]:
        rois[::3, 2] = rois[::3, 0]
        rois[[5, 8, 10]] = torch.tensor([[20.5, 2.0, 30.0, 6.0],
                                         [3.0, 11.5, 9.0, 14.0],
                                         [-7.0, 12.0, -1.5, 30.0]])
    if case == BACKWARD_CASES[4]:  # every RoI of image 0 on cells (5..6, 7..8)
        jitter = torch.rand(36, 4, generator=gen) * 0.2
        rois = torch.tensor([7.2, 5.1, 7.9, 5.8]) + jitter
        index = torch.zeros(36, dtype=torch.int32)
    rois, index = rois.to(cuda), index.to(cuda)
    cot = card_map(gen, (36, s, s, c), dtype, offset, cuda)
    assert kra.vectorized(cot, feat) == vec
    f32 = feat.float().requires_grad_()
    ref, terms = (torch.autograd.grad(
        kra.roi_align_plain(f32, rois, index, s, r), f32, g)[0]
        for g in (cot.float(), cot.float().abs()))
    before = kra.BACKWARD_LAUNCHES
    f = feat.clone().requires_grad_()
    (got,) = torch.autograd.grad(kra.roi_align(f, rois, index, s, r), f, cot)
    assert kra.BACKWARD_LAUNCHES == before + 1 and got.dtype == dtype
    assert_gradient_close(got, ref, dtype, terms)
    direct = kra.roi_align_backward_cuda(cot, rois, index, feat.shape, dtype, r)
    assert kra.BACKWARD_LAUNCHES == before + 2
    assert_gradient_close(direct, ref, dtype, terms)
    assert ref.abs().max() > 0
    if case == BACKWARD_CASES[4]:  # 36 RoIs on at most 3 x 3 cells
        assert (ref[1:] == 0).all()
        assert int((ref[0].abs().sum(-1) > 0).sum()) <= 9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BACKWARD_CASES + ("a single level",))
def test_roi_align_window_backward_kernel_edge_paths(cuda, dtype, case):
    """The FPN backward through its autograd Function and its wrapper,
    against autograd through the plain version on f32-widened maps: RoIs on
    every level and on levels -1 and 4 (no gradient), zero-width and
    off-map RoIs; the paths of the RoI Align backward; one map alone."""
    c, s, r, offset, vec = backward_shape(
        case if case in BACKWARD_CASES else BACKWARD_CASES[4], dtype)
    gen = torch.Generator().manual_seed(9)
    sides = ((26, 42), (13, 21), (7, 11), (4, 6))
    if case == "a single level":
        sides = sides[:1]
    feats = [torch.randn(3, h, w, c, generator=gen).to(dtype).to(cuda)
             for h, w in sides]
    strides = (4.0, 8.0, 16.0, 32.0)[:len(feats)]
    # Levels -1 .. len(feats) by turns: the two ends name no map.
    levels = (torch.arange(36, dtype=torch.int32) % (len(feats) + 2) - 1
              ).reshape(3, 12)
    rois = boxes(gen, 3, 12, extent=100.0)
    rois[0, 2] = torch.tensor([3.0, 4.0, 3.0, 60.0])  # zero width
    rois[0, 1] = torch.tensor([-90.0, -80.0, -20.0, -15.0])  # off the map
    if case == EDGE_CASES[3]:
        rois[:, ::3, 2] = rois[:, ::3, 0]
        rois[1, 4] = torch.tensor([500.0, 500.0, 600.0, 560.0])
        rois[2, 7] = torch.tensor([-300.0, 10.0, -200.0, 40.0])
    if case == BACKWARD_CASES[4]:  # RoIs of image 0 on a few cells of p2
        rois[0] = (torch.tensor([28.8, 20.4, 31.6, 23.2])
                   + torch.rand(12, 4, generator=gen) * 0.8)
        levels[0] = 0
    rois, levels = rois.to(cuda), levels.to(cuda)
    cot = card_map(gen, (3, 12, s, s, c), dtype, offset, cuda)
    assert krw.vectorized(cot, *feats) == vec
    wide = [f.float().requires_grad_() for f in feats]

    def plain_grad(g):
        grads = torch.autograd.grad(
            krw.roi_align_window_plain(wide, strides, rois, levels, s, r),
            wide, g, allow_unused=True)
        return [torch.zeros_like(w) if d is None else d
                for w, d in zip(wide, grads)]

    ref, terms = plain_grad(cot.float()), plain_grad(cot.float().abs())
    before = krw.BACKWARD_LAUNCHES
    maps = [f.clone().requires_grad_() for f in feats]
    got = torch.autograd.grad(
        krw.roi_align_window(maps, strides, rois, levels, s, r), maps, cot)
    assert krw.BACKWARD_LAUNCHES == before + 1
    direct = krw.roi_align_window_backward_cuda(
        cot, rois, levels, [f.shape for f in feats], strides, dtype, r)
    assert krw.BACKWARD_LAUNCHES == before + 2
    for g, d, rf, tm in zip(got, direct, ref, terms):
        assert g.dtype == d.dtype == dtype
        assert_gradient_close(g, rf, dtype, tm)
        assert_gradient_close(d, rf, dtype, tm)
    assert all(rf.abs().max() > 0 for rf in ref)
    # The RoIs whose level names no map add nothing.
    outside = ((levels < 0) | (levels >= len(feats)))[..., None, None, None]
    lost = krw.roi_align_window_backward_cuda(
        (cot * outside).contiguous(), rois, levels, [f.shape for f in feats],
        strides, dtype, r)
    assert not any(g.any() for g in lost)


@pytest.mark.parametrize("split", [False, True])
def test_precision_probe_kernel_equals_plain(cuda, split):
    """Tensor-core bf16 products with f32 accumulation against the plain
    version's f32 products of the same bf16 operands, on ragged data and a
    0/1 selector (exact)."""
    from tpudet_torch.kernels import precision_probe as kpp

    gen = torch.Generator().manual_seed(int(split))
    x = torch.randn(48, 96, generator=gen) * 3
    m = (torch.rand(96, 32, generator=gen) < 0.1).float()
    out = kpp.precision_probe_cuda(x.to(cuda), m.to(cuda), split).cpu()
    ref = kpp.precision_probe_plain(x, m, split)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-5)
    sel = torch.zeros(48, 96)
    sel[torch.arange(48), torch.randint(0, 96, (48,), generator=gen)] = 1.0
    v = torch.randn(96, 32, generator=gen).to(torch.bfloat16)
    exact = kpp.precision_probe_cuda(sel.to(cuda), v.to(cuda), split).cpu()
    assert torch.equal(exact, sel @ v.float())
    lines, failed, _ = kpp.run_probe(cuda)
    assert not failed and [ln["stage"][0] for ln in lines] == ["A", "B", "C"]
    with pytest.raises(ValueError, match="multiple of 16"):
        kpp.precision_probe_cuda(x[:40].to(cuda), m.to(cuda), split)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("rows,depth,cols", [
    (80, 400, 48),  # 25 16-deep steps: uneven over the 4 warps
    (16, 1040, 96),  # 65 steps: a second round of 8 loads per warp
])
def test_precision_probe_kernel_at_other_shapes(cuda, split, rows, depth,
                                                cols):
    """Shapes that are not the probe's own (sides multiples of 16), ragged
    values over many binades: the same bf16 products as the plain version,
    in another f32 order (K split over warps)."""
    from tpudet_torch.kernels import precision_probe as kpp

    gen = torch.Generator().manual_seed(rows + depth + cols)
    x = torch.randn(rows, depth, generator=gen) * torch.exp(
        4 * torch.randn(rows, 1, generator=gen))
    m = torch.randn(depth, cols, generator=gen).to(torch.bfloat16).float()
    out = kpp.precision_probe_cuda(x.to(cuda), m.to(cuda), split).cpu()
    # The operands the kernel multiplies, exactly, and their f64 product.
    hi = x.to(torch.bfloat16).double()
    parts = [hi, (x - hi.float()).to(torch.bfloat16).double()][:1 + split]
    mb = m.double()
    ref = sum(part @ mb for part in parts)
    terms = sum(part.abs() @ mb.abs() for part in parts)
    # f32 sums of `depth` exact products: within 1e-5 of the terms' sum.
    assert ((out.double() - ref).abs() <= 1e-5 * terms).all()
    assert out.shape == (rows, cols) and (out != 0).all()


def test_fpn_levels_on_card_equal_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    rois = boxes(gen, 4, 5000, extent=1300.0) * torch.rand(
        4, 5000, 1, generator=gen) * 3
    for fit in (0, 56):
        assert torch.equal(fpn_assign_levels(rois.to(cuda), fit_window=fit).cpu(),
                           fpn_assign_levels(rois, fit_window=fit))


def test_predict_on_card_equals_plain_path(cuda):
    from tpudet_torch.config import tiny_test_config
    from tpudet_torch.models import build_model

    cfg = tiny_test_config()
    card = build_model(cfg, device=cuda).init(seed=0)
    cpu = build_model(cfg, device="cpu").init(seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # wide enough that detections pass score_thresh
        cpu.core.det_head.cls.weight.normal_(0, 1.0, generator=gen)
    card.load_state_dict(cpu.state_dict())
    batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
             "image_hw": torch.tensor([[128.0, 128.0], [100.0, 128.0]])}
    out = card.predict({k: v.to(cuda) for k, v in batch.items()})
    ref = cpu.predict(batch)
    assert torch.equal(out["valid"].cpu(), ref["valid"])
    assert (ref["num_detections"] > 0).all()
    torch.testing.assert_close(out["boxes"].cpu(), ref["boxes"], rtol=1e-4,
                               atol=1e-3)
    torch.testing.assert_close(out["scores"].cpu(), ref["scores"], rtol=1e-4,
                               atol=1e-4)


def test_fpn_predict_on_card_equals_plain_path(cuda):
    import dataclasses

    from tpudet_torch.config import tiny_test_config
    from tpudet_torch.models import build_model

    cfg = tiny_test_config(use_fpn=True)
    cfg = cfg.replace(roi=dataclasses.replace(cfg.roi, pooler="roi_align_window",
                                              window=24))
    card = build_model(cfg, device=cuda).init(seed=0)
    cpu = build_model(cfg, device="cpu").init(seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        cpu.core.det_head.cls.weight.normal_(0, 1.0, generator=gen)
    card.load_state_dict(cpu.state_dict())
    batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
             "image_hw": torch.tensor([[128.0, 128.0], [100.0, 128.0]])}
    before = krw.LAUNCHES
    out = card.predict({k: v.to(cuda) for k, v in batch.items()})
    assert krw.LAUNCHES == before + 1
    ref = cpu.predict(batch)
    assert torch.equal(out["valid"].cpu(), ref["valid"])
    assert (ref["num_detections"] > 0).all()
    torch.testing.assert_close(out["boxes"].cpu(), ref["boxes"], rtol=1e-4,
                               atol=1e-3)
    torch.testing.assert_close(out["scores"].cpu(), ref["scores"], rtol=1e-4,
                               atol=1e-4)


def deform_inputs(gen, b, q, heads, d, level_shapes, points, dtype,
                  outside=0.1):
    """N(0, 1) values; locations with about ``outside`` of the samples out of
    their level (the zero-padding path); weights softmaxed over L x P."""
    n = sum(h * w for h, w in level_shapes)
    lv = len(level_shapes)
    values = torch.randn(b, n, heads, d, generator=gen).to(dtype)
    span = outside / 4  # per axis, each side: 1 - (1 - 2 * span)^2 ~ outside
    loc = (torch.rand(b, q, heads, lv, points, 2, generator=gen)
           * (1 + 2 * span) - span)
    weights = torch.softmax(torch.randn(b, q, heads, lv * points,
                                        generator=gen), dim=-1)
    return values, loc, weights.reshape(b, q, heads, lv, points)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d,points,shapes", [
    (8, 32, 4, ((20, 28), (10, 14), (5, 7), (3, 4))),
    (4, 8, 2, ((16, 16), (8, 8), (4, 4), (2, 2))),
    (2, 40, 3, ((1, 9), (6, 5), (2, 3))),  # a 1 x W level, D > 32
    (36, 32, 2, ((4, 5),)),  # 36 heads
])
def test_deform_attn_kernel_equals_plain(cuda, dtype, heads, d, points,
                                         shapes):
    gen = torch.Generator().manual_seed(heads * d)
    values, loc, weights = deform_inputs(gen, 2, 37, heads, d, shapes,
                                         points, dtype)
    args = (values.to(cuda), shapes, loc.to(cuda), weights.to(cuda))
    before = kda.LAUNCHES
    out = kda.ms_deform_attn_cuda(*args).cpu()
    assert kda.LAUNCHES == before + 1
    ref = kda.ms_deform_attn_plain(*args).cpu()
    assert out.dtype == torch.float32 and out.shape == ref.shape
    # Same f32 arithmetic per corner, other summation order.
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    assert (out != 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,q,heads,d,points,shapes", [
    (2, 37, 3, 6, 3, ((9, 7), (4, 3))),  # D % 4 != 0: the scalar path
    # D > 64 (bf16: 68 % 8 != 0, the scalar path), 2 levels x 17 points:
    # L * P = 34 > 32 samples, staged in two chunks.
    (1, 9, 2, 68, 17, ((5, 6), (3, 3))),
    (1, 1, 3, 8, 5, ((4, 5), (2, 3))),  # Q = 1
])
def test_deform_attn_kernel_at_edges(cuda, dtype, b, q, heads, d, points,
                                     shapes):
    """The forward's scalar path, its chunked staging and channel loop, and
    a grid of fewer pairs than one block holds."""
    gen = torch.Generator().manual_seed(heads * d + q)
    values, loc, weights = deform_inputs(gen, b, q, heads, d, shapes, points,
                                         dtype, outside=0.2)
    args = (values.to(cuda), shapes, on_borders(loc, shapes).to(cuda),
            weights.to(cuda))
    out = kda.ms_deform_attn_cuda(*args).cpu()
    ref = kda.ms_deform_attn_plain(*args).cpu()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    assert (out != 0).any()


def plain_grads(values, shapes, loc, weights, grad_out):
    """The reference gradients: ``torch.autograd.grad`` through the plain
    version, with the values widened to f32 (the plain forward widens its
    gathered corners exactly, so this is the same function; its f32 value
    gradient is what the kernel sums before its one cast)."""
    v = values.float().requires_grad_()
    loc = loc.clone().requires_grad_()
    weights = weights.clone().requires_grad_()
    out = kda.ms_deform_attn_plain(v, shapes, loc, weights)
    return torch.autograd.grad(out, (v, loc, weights), grad_out)


def on_borders(loc, shapes):
    """Puts some samples exactly on their level's edges and cell centres:
    x in {0, 1} (half a cell outside the first and last column), the first
    cell's centre, and just outside the grid."""
    for li, (hl, wl) in enumerate(shapes):
        for p, value in enumerate((0.0, 1.0, 0.5 / wl, -0.5 / wl, 1.0 + 0.5 / wl)):
            if p < loc.shape[4]:
                loc[:, ::3, :, li, p, 0] = value
                loc[:, 1::3, :, li, p, 1] = min(max(value, 0.0), 1.0)
    return loc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,q,heads,d,points,shapes", [
    (2, 37, 8, 32, 4, ((20, 28), (10, 14), (5, 7), (3, 4))),
    (2, 37, 4, 8, 2, ((16, 16), (8, 8), (4, 4), (2, 2))),
    (2, 37, 2, 40, 3, ((1, 9), (6, 5), (2, 3))),  # a 1 x W level, D > 32
    (1, 1, 3, 8, 5, ((4, 5), (2, 3))),  # Q = 1
    (2, 5, 36, 32, 2, ((4, 5),)),  # 36 heads
    (2, 37, 3, 6, 3, ((9, 7), (4, 3))),  # D % 4 != 0: the scalar path
    # D > 64, 2 levels x 17 points: L * P = 34 > 32 samples, two chunks.
    (1, 9, 2, 68, 17, ((5, 6), (3, 3))),
])
def test_deform_attn_backward_kernel_equals_plain(cuda, dtype, b, q, heads, d,
                                                  points, shapes):
    gen = torch.Generator().manual_seed(heads * d + q)
    values, loc, weights = deform_inputs(gen, b, q, heads, d, shapes, points,
                                         dtype, outside=0.2)
    check_backward(cuda, values, shapes, on_borders(loc, shapes), weights,
                   torch.randn(b, q, heads, d, generator=gen))


def test_deform_attn_backward_kernel_under_contention(cuda):
    """Every query of both images samples within a cell or two of one point
    of each level, so thousands of corners add into the same few value rows
    at once: the atomics must lose no addition."""
    gen = torch.Generator().manual_seed(11)
    shapes = ((12, 16), (6, 8), (3, 4))
    b, q, heads, d, points = 2, 600, 4, 32, 4
    for dtype in (torch.float32, torch.bfloat16):
        values, _, weights = deform_inputs(gen, b, q, heads, d, shapes, points,
                                           dtype)
        loc = (torch.tensor([0.47, 0.53])
               + 0.02 * torch.randn(b, q, heads, len(shapes), points, 2,
                                    generator=gen))
        check_backward(cuda, values, shapes, loc, weights,
                       torch.randn(b, q, heads, d, generator=gen))


def check_backward(cuda, values, shapes, loc, weights, grad_out):
    """The backward kernel against autograd through the plain version."""
    dtype = values.dtype
    args = (values.to(cuda), shapes, loc.to(cuda), weights.to(cuda))
    before = kda.BACKWARD_LAUNCHES
    dv, dloc, dw = kda.ms_deform_attn_backward_cuda(*args, grad_out.to(cuda))
    assert kda.BACKWARD_LAUNCHES == before + 1
    assert dv.dtype == dtype and dloc.dtype == dw.dtype == torch.float32
    ref_v, ref_loc, ref_w = (g.cpu() for g in plain_grads(*args,
                                                          grad_out.to(cuda)))
    # f32 sums of the same products in other orders (atomics for dV, warp
    # shuffles for the corner dot products): within 1e-5 of each
    # gradient's largest magnitude (dloc carries the factor W_l).
    for got, ref in ((dloc, ref_loc), (dw, ref_w)):
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-5,
                                   atol=1e-5 * ref.abs().max().item())
    if dtype == torch.float32:
        torch.testing.assert_close(dv.cpu(), ref_v, rtol=1e-5,
                                   atol=1e-5 * ref_v.abs().max().item())
    else:  # one rounding of the f32 sum: at most one bf16 ulp apart
        err = (dv.cpu().float() - ref_v).abs()
        assert (err <= 2 ** -8 * ref_v.abs() + 1e-5 * ref_v.abs().max()).all()
    assert (ref_loc != 0).any() and (ref_v != 0).any()


def test_deform_attn_autograd_runs_both_kernels(cuda):
    """``ms_deform_attn`` on CUDA tensors that need gradients: one forward
    and one backward launch, and the gradients of the backward kernel."""
    gen = torch.Generator().manual_seed(5)
    shapes = ((6, 7), (3, 4))
    values, loc, weights = deform_inputs(gen, 2, 9, 4, 8, shapes, 2,
                                         torch.float32)
    inputs = [x.to(cuda).requires_grad_() for x in (values, loc, weights)]
    grad_out = torch.randn(2, 9, 4, 8, generator=gen).to(cuda)
    before = (kda.LAUNCHES, kda.BACKWARD_LAUNCHES)
    out = kda.ms_deform_attn(inputs[0], shapes, inputs[1], inputs[2])
    grads = torch.autograd.grad(out, inputs, grad_out)
    assert (kda.LAUNCHES, kda.BACKWARD_LAUNCHES) == (before[0] + 1,
                                                     before[1] + 1)
    direct = kda.ms_deform_attn_backward_cuda(
        *(x.detach() for x in inputs[:1]), shapes,
        *(x.detach() for x in inputs[1:]), grad_out)
    for got, ref in zip(grads, direct):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_deform_attn_kernel_rejects_what_it_does_not_take(cuda):
    gen = torch.Generator().manual_seed(0)
    shapes = ((4, 4),) * 5
    values, loc, weights = deform_inputs(gen, 1, 3, 2, 8, shapes, 2,
                                         torch.float32)
    with pytest.raises(ValueError, match="levels"):
        kda.ms_deform_attn_cuda(values.to(cuda), shapes, loc.to(cuda),
                                weights.to(cuda))
    with pytest.raises(ValueError, match="CUDA"):
        kda.ms_deform_attn_cuda(values, shapes[:4], loc[:, :, :, :4],
                                weights[:, :, :, :4])
    args = (values[:, :64].contiguous().to(cuda), shapes[:4],
            loc[:, :, :, :4].contiguous().to(cuda),
            weights[:, :, :, :4].contiguous().to(cuda))
    with pytest.raises(ValueError, match="cotangent"):
        kda.ms_deform_attn_backward_cuda(
            *args, torch.zeros(1, 3, 2, 8, dtype=torch.bfloat16, device=cuda))
    # 100 heads x 4 levels x 4 points: 1,600 samples per query. Both kernels
    # stage a warp's samples 32 at a time, so they take any count.
    shapes = ((3, 4),) * 4
    values, loc, weights = deform_inputs(gen, 1, 5, 100, 4, shapes, 4,
                                         torch.float32)
    args = (values.to(cuda), shapes, loc.to(cuda), weights.to(cuda))
    torch.testing.assert_close(kda.ms_deform_attn_cuda(*args),
                               kda.ms_deform_attn_plain(*args), rtol=0,
                               atol=1e-5)
    check_backward(cuda, values, shapes, loc, weights,
                   torch.randn(1, 5, 100, 4, generator=gen))


def test_deformable_detr_predict_on_card_equals_plain_path(cuda):
    import dataclasses

    from tpudet_torch.config import tiny_deformable_detr_config
    from tpudet_torch.models import build_model

    for refine in (False, True):
        cfg = tiny_deformable_detr_config()
        cfg = cfg.replace(deformable_detr=dataclasses.replace(
            cfg.deformable_detr, with_box_refine=refine))
        card = build_model(cfg, device=cuda).init(seed=0)
        cpu = build_model(cfg, device="cpu").init(seed=0)
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():  # spread the samples and the class scores
            for name, p in cpu.core.named_parameters():
                if name.endswith(("sampling_offsets.weight",
                                  "attention_weights.weight")):
                    p.normal_(0, 0.1, generator=gen)
                elif "class_head" in name and name.endswith("weight"):
                    p.normal_(0, 0.5, generator=gen)
        card.load_state_dict(cpu.state_dict())
        batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
                 "image_hw": torch.tensor([[128.0, 128.0], [96.0, 112.0]])}
        before = kda.LAUNCHES
        out = card.predict({k: v.to(cuda) for k, v in batch.items()})
        assert kda.LAUNCHES == before + 4  # 2 encoder + 2 decoder layers
        ref = cpu.predict(batch)
        assert torch.equal(out["valid"].cpu(), ref["valid"])
        assert (ref["num_detections"] > 0).all()
        torch.testing.assert_close(out["boxes"].cpu(), ref["boxes"],
                                   rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(out["scores"].cpu(), ref["scores"],
                                   rtol=1e-4, atol=1e-4)


def test_deformable_detr_train_step_on_card_equals_plain_path(cuda):
    """Two AdamW steps of the tiny Deformable DETR (f32, dropout 0) on the
    card, through both deformable attention kernels, against the same steps
    on the CPU plain path: losses within 1e-5 relative, parameters after
    the updates within 1e-2 of how far they moved (Adam amplifies the
    rounding of near-zero gradient elements) where the gradient is not
    rounding noise."""
    import dataclasses

    from tpudet_torch.config import tiny_deformable_detr_config
    from tpudet_torch.models import build_model
    from tpudet_torch.train.state import create_train_state
    from tpudet_torch.train.step import make_train_step

    cfg = tiny_deformable_detr_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, optimizer="adamw", learning_rate=1e-3, warmup_steps=0,
        grad_clip_norm=0.1, weight_decay=1e-4))
    gen = torch.Generator().manual_seed(2)
    boxes = torch.tensor([[[10.0, 12.0, 60.0, 70.0], [40.0, 30.0, 120.0, 90.0],
                           [0.0, 0.0, 0.0, 0.0]]] * 2)
    batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
             "image_hw": torch.tensor([[128.0, 128.0], [96.0, 112.0]]),
             "gt_boxes": boxes, "gt_classes": torch.tensor([[1, 3, 0]] * 2),
             "gt_valid": torch.tensor([[True, True, False]] * 2)}
    runs = {}
    for device in (cuda, "cpu"):
        model = build_model(cfg, device=device)
        state = create_train_state(model, cfg.train, seed=0, device=device)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        step = make_train_step(model, cfg, device=device)
        launches = (kda.LAUNCHES, kda.BACKWARD_LAUNCHES)
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
        launched = (kda.LAUNCHES - launches[0],
                    kda.BACKWARD_LAUNCHES - launches[1])
        grads = {k: p.grad.cpu() for k, p in state.params.items()}
        runs[str(device)] = (losses, launched, before, grads,
                             {k: p.detach().cpu()
                              for k, p in state.params.items()})
    card, cpu = runs[str(cuda)], runs["cpu"]
    assert card[1] == (8, 8) and cpu[1] == (0, 0)  # 4 layers x 2 steps
    for a, b in zip(card[0], cpu[0]):
        assert a == pytest.approx(b, rel=1e-5)
    floor = 1e-6 * float(torch.stack([g.norm() for g in cpu[3].values()]).norm())
    for name, p in cpu[4].items():
        if float(cpu[3][name].norm()) <= floor:
            continue
        moved = float((p - cpu[2][name].cpu()).norm())
        assert float((card[4][name] - p).norm()) <= 1e-2 * moved, name


def test_faster_rcnn_train_step_on_card_equals_plain_path(cuda):
    """One SGD step of the tiny Faster R-CNN (f32) on the card, through the
    NMS kernel and both RoI Align kernels, against the same step on the CPU
    plain path, the samplers given the same draws: equal samples, loss within
    1e-5 relative, each gradient within 1e-3 of its norm and each parameter
    after the update within 1e-2 of how far it moved (gradients that are
    rounding noise aside)."""
    import numpy as np

    from tpudet_torch.config import tiny_test_config
    from tpudet_torch.models import build_model
    from tpudet_torch.train.state import create_train_state
    from tpudet_torch.train.step import make_train_step

    cfg = tiny_test_config()
    gen = torch.Generator().manual_seed(3)
    boxes = torch.tensor([[[10.0, 12.0, 60.0, 70.0], [40.0, 30.0, 120.0, 90.0]]
                          + [[0.0] * 4] * 8] * 2)
    batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
             "image_hw": torch.tensor([[128.0, 128.0], [96.0, 112.0]]),
             "gt_boxes": boxes, "gt_classes": torch.tensor([[1, 3] + [0] * 8] * 2),
             "gt_valid": torch.tensor([[True, True] + [False] * 8] * 2)}
    rng = np.random.default_rng(4)
    shapes = build_model(cfg, device="cpu").draw_shapes(2, (128, 128))
    draws = {k: tuple(torch.from_numpy(rng.random(s, dtype=np.float32))
                      for _ in range(2)) for k, s in shapes.items()}
    runs = {}
    for device in (cuda, "cpu"):
        model = build_model(cfg, device=device)
        state = create_train_state(model, cfg.train, seed=0, device=device)
        before = {k: v.detach().clone().cpu() for k, v in state.params.items()}
        original, samples = model.loss, []
        on_dev = {k: tuple(d.to(device) for d in v) for k, v in draws.items()}
        model.loss = lambda b, draws=None: original(b, draws=on_dev)
        roi_targets = model._roi_targets_single
        model._roi_targets_single = lambda *a: samples.append(
            roi_targets(*a)) or samples[-1]
        counts = (knms.LAUNCHES, kra.LAUNCHES, kra.BACKWARD_LAUNCHES)
        _, metrics = make_train_step(model, cfg, device=device)(state, batch)
        launched = tuple(c - c0 for c, c0 in zip(
            (knms.LAUNCHES, kra.LAUNCHES, kra.BACKWARD_LAUNCHES), counts))
        runs[str(device)] = (float(metrics["loss"]), launched, before,
                             {k: p.grad.cpu() for k, p in state.params.items()},
                             {k: p.detach().cpu() for k, p in state.params.items()},
                             [s.cpu() for s in samples[0][1:]])
    card, cpu = runs[str(cuda)], runs["cpu"]
    assert card[1] == (1, 1, 1) and cpu[1] == (0, 0, 0)
    for a, b in zip(card[5], cpu[5]):  # classes, deltas, fg, valid, matches
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        else:
            assert torch.equal(a, b)
    assert card[0] == pytest.approx(cpu[0], rel=1e-5)
    floor = 1e-6 * float(torch.stack([g.norm() for g in cpu[3].values()]).norm())
    for name, g in cpu[3].items():
        if float(g.norm()) <= floor:
            continue
        assert float((card[3][name] - g).norm()) <= 1e-3 * float(g.norm()), name
        moved = float((cpu[4][name] - cpu[2][name]).norm())
        assert float((card[4][name] - cpu[4][name]).norm()) <= 1e-2 * moved, name


def test_voc_r50_f32_step_at_128_differs_only_off_the_positives(cuda):
    """The full voc_r50 preset's f32 b=2 train step at 128x128 on the card
    against the CPU, as ``chip_smoke.py`` runs it at 320x320 (its planted
    batch and sampler draws). Proposal keeps, samples, labels and matched
    ground truth are equal on every row; regression targets may differ only
    on rows that are not sampled positives and overlap no ground truth
    (near-degenerate proposals, whose deltas scale with 1 / width, so the
    last bits of a tiny width show); the loss, which reads positives only,
    within 1e-4 and every gradient within 1e-2 of its norm. Prints, per
    field, how many rows differ."""
    import chip_smoke
    from tpudet_torch.cli.common import preset_config
    from tpudet_torch.models import build_model
    from tpudet_torch.ops import boxes as box_ops

    batch, runs, _ = chip_smoke.reference_runs("voc_r50", 128)
    card, cpu = runs["cuda"], runs["cpu"]
    gt, gt_valid = batch["gt_boxes"].cpu(), batch["gt_valid"].cpu()
    anchors = build_model(preset_config("voc_r50"),
                          device="cpu").anchor_boxes((128, 128))
    for key, (names, positives) in chip_smoke.REFERENCE_FIELDS.items():
        mask = positives(cpu["seen"][key]) if positives else None
        for name, a, b in zip(names, card["seen"][key], cpu["seen"][key]):
            bad = (~torch.isclose(a, b, rtol=1e-4, atol=1e-3)
                   if a.dtype.is_floating_point else a != b)
            rows = bad.reshape(a.shape[0], a.shape[1], -1).any(-1)
            print(f"{key} {name}: {int(rows.sum())} of {rows.numel()} rows "
                  f"differ, {a[rows][:2].tolist()} vs {b[rows][:2].tolist()}")
            if name != "deltas" or not rows.any():
                assert not rows.any(), (key, name)
                continue
            assert not (rows & mask).any(), (key, name)
            sampled = cpu["seen"][key][0]
            boxes = anchors[sampled.long()] if key.startswith("_rpn") else sampled
            iou = torch.where(gt_valid[:, None, :],
                              box_ops.pairwise_iou(boxes, gt), 0.0)
            assert float(iou.amax(-1)[rows].max()) == 0.0, (key, name)
    assert card["loss"] == pytest.approx(cpu["loss"], rel=1e-4)
    floor = 1e-6 * float(torch.stack([g.norm() for g in cpu["grads"].values()]
                                     ).norm())
    for name, g in cpu["grads"].items():
        err = float((card["grads"][name] - g).norm())
        assert err <= 1e-2 * max(float(g.norm()), floor), name


@pytest.mark.parametrize("classes", [8, 20])
def test_final_nms_at_the_evaluators_shape_equals_plain(cuda, classes):
    """The final per-class NMS under the eval CLI's referee config: every
    (box, class) candidate of 300 proposals (2,400 per image at the
    synthetic dataset's 8 classes, 6,000 at VOC's 20), class-shifted, a
    few objects per image so that the walk crosses most blocks; 0.5 ->
    100, through ``class_aware_select`` against the CPU's plain version."""
    gen = torch.Generator().manual_seed(classes)
    b, n = 4, 300 * classes
    centres = torch.rand(b, 3, 2, generator=gen) * 500
    pick = torch.randint(0, 3, (b, n), generator=gen)
    centre = torch.gather(centres, 1, pick[..., None].expand(b, n, 2))
    wh = 40 + torch.rand(b, n, 2, generator=gen) * 60
    bx = torch.cat([centre - wh / 2, centre + wh / 2], -1)
    bx = bx + torch.randn(b, n, 4, generator=gen) * 3
    scores = torch.rand(b, n, generator=gen)
    cls = torch.arange(1, classes + 1, dtype=torch.int32).repeat(300)
    cls = cls[None].expand(b, n).contiguous()
    valid = scores > 0.05
    ref = tk.class_aware_select(bx, scores, cls, 0.5, 100, valid_mask=valid)
    out = tk.class_aware_select(bx.to(cuda), scores.to(cuda), cls.to(cuda),
                                0.5, 100, valid_mask=valid.to(cuda))
    for got, want in zip(out, ref):
        assert torch.equal(got.cpu(), want)
    assert int(ref[2].sum()) > b  # several keeps per image


def test_loader_device_stream_on_card_equals_host(cuda):
    """Pinned batches copied on the loader's side stream arrive on the card
    equal to the host batches, in order."""
    from tpudet_torch.config import tiny_test_config
    from tpudet_torch.data import DataLoader
    from tpudet_torch.data.synthetic import SyntheticDataset

    loader = DataLoader(tiny_test_config(), SyntheticDataset(3, 10), 4,
                        num_workers=2, prefetch=3)
    host = list(loader.batches(0)) + list(loader.batches(1))
    stream = loader.device_stream(cuda)
    for want in host:
        got = next(stream)
        for k, v in want.items():
            assert got[k].device.type == "cuda"
            assert torch.equal(got[k].cpu(), torch.from_numpy(v)), k
    stream.close()


def test_device_preprocess_training_on_card_equals_cpu(cuda):
    """The colour jitter and flip on the card, given the same draws, within
    1e-4 of the CPU (normalized f32); boxes equal."""
    import dataclasses

    from tpudet_torch.config import tiny_test_config
    from tpudet_torch.data.preprocess import augment_draws, device_preprocess

    cfg = tiny_test_config()
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, color_jitter=(0.125, 0.5, 0.5, 0.05)))
    gen = torch.Generator().manual_seed(3)
    batch = {"image": torch.randint(0, 256, (4, 48, 64, 3), generator=gen,
                                    dtype=torch.uint8),
             "image_hw": torch.tensor([[48.0, 64.0], [40.0, 50.0],
                                       [30.0, 64.0], [48.0, 33.0]]),
             "gt_boxes": torch.rand(4, 5, 4, generator=gen) * 30}
    draws = augment_draws(gen, 4)
    ref = device_preprocess(cfg, batch, training=True, draws=draws)
    out = device_preprocess(cfg, {k: v.to(cuda) for k, v in batch.items()},
                            training=True,
                            draws={k: v.to(cuda) for k, v in draws.items()})
    torch.testing.assert_close(out["image"].cpu(), ref["image"], atol=1e-4,
                               rtol=0)
    assert torch.equal(out["gt_boxes"].cpu(), ref["gt_boxes"])


def test_benchmark_infer_on_card(cuda):
    """``cli.benchmark --mode infer`` on the card: its line names the card,
    its rates are finite and positive, and each predict launched 2 NMS and
    1 RoI Align (2 pipelined + 2 synced warm-ups and 2 + 2 timed calls)."""
    import math

    from tpudet_torch.cli import benchmark as bench

    before = (knms.LAUNCHES, kra.LAUNCHES)
    line = bench.main(["--preset", "tiny", "--mode", "infer", "--batch-size",
                       "2", "--iters", "2"])
    predicts = 2 * (bench.WARMUP + 2)
    assert (knms.LAUNCHES - before[0], kra.LAUNCHES - before[1]) == (
        2 * predicts, predicts)
    assert line["backend"] == "cuda"
    assert line["device"] == torch.cuda.get_device_name(0)
    for key in ("value", "sec_per_batch", "sec_per_batch_synced"):
        assert math.isfinite(line[key]) and line[key] > 0, key


def test_benchmark_nms_on_card(cuda):
    """``cli.benchmark --mode nms`` times CUDA-graph replays: the wrapper
    counts the warm-up calls before each graph and the captured calls."""
    from tpudet_torch.cli import benchmark as bench

    before = knms.LAUNCHES
    line = bench.main(["--preset", "tiny", "--mode", "nms", "--iters", "2"])
    assert knms.LAUNCHES - before == 2 * bench.WARMUP + 1 + bench.NMS_REPS
    assert line["route"] == "cuda" and line["clock"] == "cuda_graph"
    assert line["num_boxes"] == 6000
    assert line["t_many_calls_us"] > line["t_one_call_us"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_window_at_the_mask_size_equals_plain(cuda, dtype):
    """Mask R-CNN's pooling size S = 14 at r = 2 (the kernels' runtime-S
    instantiations; the box head's S = 7 is compiled in): the forward and,
    through the autograd Function, the backward on the 16-byte path, with
    slivers, RoIs across the border and zero rows, against the plain
    version (the backward against autograd through it on f32-widened
    maps)."""
    gen = torch.Generator().manual_seed(14)
    c, s, r = 256, 14, 2
    feats = [torch.randn(2, h, w, c, generator=gen).to(dtype).to(cuda)
             for h, w in ((52, 60), (26, 30), (13, 15), (7, 8))]
    strides = (4.0, 8.0, 16.0, 32.0)
    rois = boxes(gen, 2, 20, extent=200.0)
    rois[0, 0] = torch.tensor([3.0, 4.0, 7.0, 180.0])  # a sliver
    rois[1, 1] = torch.tensor([-30.0, -20.0, 40.0, 50.0])  # across the border
    rois[:, 5] = 0.0  # invalid slots
    rois = rois.to(cuda)
    levels = (fpn_assign_levels(rois, fit_window=56) - 2).contiguous()
    out = krw.roi_align_window_cuda(feats, strides, rois, levels, s, r)
    ref = krw.roi_align_window_plain(feats, strides, rois, levels, s, r)
    assert out.shape == (2, 20, s, s, c)
    out, ref = out.float(), ref.float()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:
        assert ((out - ref).abs() <= 2 ** -7 * ref.abs() + 1e-6).all()
    cot = torch.randn(2, 20, s, s, c, generator=gen).to(dtype).to(cuda)
    maps = [f.clone().requires_grad_() for f in feats]
    before = krw.BACKWARD_LAUNCHES
    got = torch.autograd.grad(
        krw.roi_align_window(maps, strides, rois, levels, s, r), maps, cot)
    assert krw.BACKWARD_LAUNCHES == before + 1
    wide = [f.float().requires_grad_() for f in feats]

    def plain_grad(g):
        grads = torch.autograd.grad(
            krw.roi_align_window_plain(wide, strides, rois, levels, s, r),
            wide, g, allow_unused=True)
        return [torch.zeros_like(w) if d is None else d
                for w, d in zip(wide, grads)]

    ref, terms = plain_grad(cot.float()), plain_grad(cot.float().abs())
    for g, want, t in zip(got, ref, terms):
        assert_gradient_close(g, want, dtype, t)


def test_one_rank_nccl_step_equals_the_ungrouped_step(cuda):
    """make_train_step in a one-rank NCCL group on the card: the all-reduce
    of the flat gradients returns them bit for bit (a sum over one rank,
    divided by 1), and the step equals the ungrouped step (tiny, b=2; the
    backward kernels add with atomics, so two runs agree to rounding)."""
    import dataclasses
    import socket

    from tpudet_torch.config import tiny_test_config
    from tpudet_torch.models import build_model
    from tpudet_torch.parallel import DataParallel, init_data_parallel
    from tpudet_torch.train.state import create_train_state
    from tpudet_torch.train.step import make_train_step

    exact = []

    class Checked(DataParallel):
        def all_reduce_mean_(self, tensor):
            before = tensor.clone()
            out = super().all_reduce_mean_(tensor)
            exact.append(torch.equal(before, out))
            return out

    cfg = tiny_test_config()
    gen = torch.Generator().manual_seed(3)
    batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
             "image_hw": torch.tensor([[128.0, 128.0], [96.0, 112.0]]),
             "gt_boxes": torch.tensor([[[10.0, 12.0, 70.0, 80.0]] * 2
                                       + [[0.0] * 4] * 8] * 2),
             "gt_classes": torch.tensor([[1, 2] + [0] * 8] * 2),
             "gt_valid": torch.tensor([[True, True] + [False] * 8] * 2)}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    group = init_data_parallel("cuda", rank=0, world_size=1,
                               init_method=f"tcp://127.0.0.1:{port}")
    runs = []
    try:
        for dp in (None, Checked(**dataclasses.asdict(group))):
            model = build_model(cfg, device=group.device)
            state = create_train_state(model, cfg.train, seed=0,
                                       device=group.device)
            step = make_train_step(model, cfg, device=group.device, dp=dp)
            state, metrics = step(state, batch)
            runs.append((metrics, {k: p.detach().cpu()
                                   for k, p in state.params.items()}))
    finally:
        group.close()
    assert exact and all(exact)
    (alone, p_alone), (grouped, p_grouped) = runs
    for k, v in alone.items():
        assert float(grouped[k]) == pytest.approx(float(v), rel=1e-6), k
    scale = max(float(p.abs().max()) for p in p_alone.values())
    for k, p in p_alone.items():
        torch.testing.assert_close(p_grouped[k], p, rtol=0, atol=1e-6 * scale)


def family_pair(cuda, name, seed=0):
    """The tiny preset ``name`` on the card and on the CPU with the same
    weights, its class scores widened so that detections pass
    score_thresh."""
    from tpudet_torch.cli.common import preset_config
    from tpudet_torch.models import build_model

    cfg = preset_config(name)
    cpu = build_model(cfg, device="cpu").init(seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for head in ("det_head", "det_head2", "det_head3"):
            if hasattr(cpu.core, head):
                getattr(cpu.core, head).cls.weight.normal_(0, 1.0,
                                                           generator=gen)
        for head in ("mask_head", "semantic_head"):
            if getattr(cpu.core, head, None) is not None:
                getattr(cpu.core, head).predict.weight.normal_(
                    0, 0.3, generator=gen)
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
             "image_hw": torch.tensor([[128.0, 128.0], [100.0, 120.0]])}
    return cfg, card, cpu, batch


@pytest.mark.parametrize("name,launches", [
    ("cascade_tiny", {"roi_align": 3}),
    ("keypoint_tiny", {"roi_align": 2}),
    ("panoptic_tiny", {"roi_align_window": 2})])
def test_family_predict_on_card_equals_plain_path(cuda, name, launches):
    """cascade_tiny (three stages pooled on c4), keypoint_tiny and
    panoptic_tiny (FPN): detections, keypoints, masks and the semantic map
    on the card equal to the CPU's; the RoI Align launches per predict."""
    _, card, cpu, batch = family_pair(cuda, name)
    counts = {"roi_align": lambda: kra.LAUNCHES,
              "roi_align_window": lambda: krw.LAUNCHES}
    before = {k: counts[k]() for k in launches}
    out = card.predict({k: v.to(cuda) for k, v in batch.items()})
    assert {k: counts[k]() - before[k] for k in launches} == launches
    ref = cpu.predict(batch)
    assert torch.equal(out["valid"].cpu(), ref["valid"])
    assert (ref["num_detections"] > 0).all()
    torch.testing.assert_close(out["boxes"].cpu(), ref["boxes"], rtol=1e-4,
                               atol=1e-3)
    torch.testing.assert_close(out["scores"].cpu(), ref["scores"], rtol=1e-4,
                               atol=1e-4)
    if "keypoints" in ref:
        torch.testing.assert_close(out["keypoints"].cpu(), ref["keypoints"],
                                   rtol=1e-4, atol=1e-3)
    if "masks" in ref:
        torch.testing.assert_close(out["masks"].cpu(), ref["masks"],
                                   rtol=0, atol=1e-4)
    if "semantic" in ref:
        assert torch.equal(out["semantic"].cpu(), ref["semantic"])


def test_argmax_of_ties_on_card_takes_the_first(cuda):
    """The keypoint decode and the semantic map take the first maximum, as
    jnp.argmax: torch.argmax on the card does too, over the heatmap's
    cells and over the class axis."""
    x = torch.zeros(3, 56 * 56, 17, device=cuda)
    x[:, 100] = x[:, 2000] = x[:, 3135] = 1.0
    assert (torch.argmax(x, dim=1) == 100).all()
    y = torch.zeros(2, 200, 304, 133, device=cuda)
    y[..., 7] = y[..., 90] = 1.0
    assert (torch.argmax(y, dim=-1) == 7).all()


def test_keypoint_and_semantic_flip_on_card_equals_cpu(cuda):
    from tpudet_torch.cli.common import preset_config
    from tpudet_torch.data.preprocess import augment_draws, device_preprocess

    cfg = preset_config("keypoint_tiny")
    cfg = cfg.replace(data=cfg.data.__class__(
        **{**cfg.data.__dict__, "load_semantic": True}))
    gen = torch.Generator().manual_seed(4)
    kps = torch.rand(4, 5, 5, 3, generator=gen) * 60
    kps[..., 2] = torch.randint(0, 3, (4, 5, 5), generator=gen).float()
    batch = {"image": torch.randint(0, 256, (4, 64, 64, 3), generator=gen,
                                    dtype=torch.uint8),
             "image_hw": torch.tensor([[64.0, 64.0], [50.0, 41.0],
                                       [64.0, 30.0], [33.0, 64.0]]),
             "gt_boxes": torch.rand(4, 5, 4, generator=gen) * 30,
             "gt_keypoints": kps,
             "gt_semantic": torch.randint(0, 5, (4, 16, 16), generator=gen,
                                          dtype=torch.int32)}
    draws = augment_draws(gen, 4)
    draws["flip"] = torch.tensor([True, True, False, True])
    ref = device_preprocess(cfg, batch, training=True, draws=draws)
    out = device_preprocess(cfg, {k: v.to(cuda) for k, v in batch.items()},
                            training=True,
                            draws={k: v.to(cuda) for k, v in draws.items()})
    for k in ("gt_boxes", "gt_keypoints", "gt_semantic"):
        assert torch.equal(out[k].cpu(), ref[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_window_backward_at_the_keypoint_shape(cuda, dtype):
    """Keypoint R-CNN's branch: S = 14 over 128 positives per image (a
    quarter of 512), the backward through the autograd Function against
    autograd through the plain version on f32-widened maps."""
    gen = torch.Generator().manual_seed(128)
    c, s, r = 256, 14, 2
    feats = [torch.randn(2, h, h, c, generator=gen).to(dtype).to(cuda)
             for h in (52, 26, 13, 7)]
    strides = (4.0, 8.0, 16.0, 32.0)
    rois = boxes(gen, 2, 128, extent=190.0).to(cuda)
    levels = (fpn_assign_levels(rois, fit_window=56) - 2).contiguous()
    cot = torch.randn(2, 128, s, s, c, generator=gen).to(dtype).to(cuda)
    maps = [f.clone().requires_grad_() for f in feats]
    before = krw.BACKWARD_LAUNCHES
    got = torch.autograd.grad(
        krw.roi_align_window(maps, strides, rois, levels, s, r), maps, cot)
    assert krw.BACKWARD_LAUNCHES == before + 1
    wide = [f.float().requires_grad_() for f in feats]

    def plain_grad(g):
        grads = torch.autograd.grad(
            krw.roi_align_window_plain(wide, strides, rois, levels, s, r),
            wide, g, allow_unused=True)
        return [torch.zeros_like(w) if d is None else d
                for w, d in zip(wide, grads)]

    ref, terms = plain_grad(cot.float()), plain_grad(cot.float().abs())
    for g, want, t in zip(got, ref, terms):
        assert_gradient_close(g, want, dtype, t)


def one_stage_pair(cuda, name, seed=0, **fields):
    """The tiny RetinaNet, FCOS or DETR preset on the card and on the CPU
    with the same weights (``fields`` replacing entries of the family's
    group), the output convs drawn wider so that detections pass
    score_thresh."""
    import dataclasses

    from tpudet_torch.cli.common import preset_config
    from tpudet_torch.models import build_model

    cfg = preset_config(name)
    group = cfg.model
    if fields:
        cfg = cfg.replace(**{group: dataclasses.replace(getattr(cfg, group),
                                                        **fields)})
    cpu = build_model(cfg, device="cpu").init(seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for layer, std in (("cls_logits", 0.05), ("box_deltas", 0.02),
                           ("box_dists", 0.02), ("centerness", 0.05)):
            conv = getattr(getattr(cpu.core, "head", None), layer, None)
            if conv is not None:
                conv.weight.normal_(0, std, generator=gen)
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
             "image_hw": torch.tensor([[128.0, 128.0], [100.0, 120.0]])}
    return cfg, card, cpu, batch


@pytest.mark.parametrize("name,fields,nms", [
    ("retinanet_tiny", {"prefilter": "off"}, 1),
    ("retinanet_tiny", {"prefilter": "on"}, 1),
    ("fcos_tiny", {}, 1), ("detr_tiny", {}, 0)])
def test_one_stage_and_detr_predict_on_card_equals_plain_path(cuda, name,
                                                              fields, nms):
    """retinanet_tiny with the prefilter off and on, fcos_tiny and
    detr_tiny on the card against the CPU: one NMS launch per RetinaNet or
    FCOS predict (the class-aware select over the levels' union), none for
    DETR; the detections equal."""
    _, card, cpu, batch = one_stage_pair(cuda, name, **fields)
    before = (knms.LAUNCHES, kra.LAUNCHES, krw.LAUNCHES, kda.LAUNCHES)
    out = card.predict({k: v.to(cuda) for k, v in batch.items()})
    after = (knms.LAUNCHES, kra.LAUNCHES, krw.LAUNCHES, kda.LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == (nms, 0, 0, 0)
    ref = cpu.predict(batch)
    assert torch.equal(out["valid"].cpu(), ref["valid"])
    assert (ref["num_detections"] > 0).all()
    assert torch.equal(out["classes"].cpu(), ref["classes"])
    torch.testing.assert_close(out["boxes"].cpu(), ref["boxes"], rtol=1e-4,
                               atol=1e-3)
    torch.testing.assert_close(out["scores"].cpu(), ref["scores"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["retinanet_tiny", "fcos_tiny", "detr_tiny"])
def test_one_stage_and_detr_train_step_on_card_equals_plain_path(cuda, name):
    """One f32 step of each tiny preset (its SGD, clipped) on the
    card against the CPU: the same metrics within 1e-5 relative, each
    gradient within 1e-2 of its norm; a gradient that is zero in exact
    arithmetic (the biases before a GroupNorm), below 1e-6 of the global
    norm on the CPU, is rounding noise and must be so on the card."""
    from tpudet_torch.train.state import create_train_state
    from tpudet_torch.train.step import make_train_step

    cfg, card, cpu, _ = one_stage_pair(cuda, name)
    gen = torch.Generator().manual_seed(5)
    boxes = torch.tensor([[[10.0, 12.0, 60.0, 70.0], [40.0, 30.0, 120.0, 90.0],
                           [20.0, 20.0, 44.0, 40.0]]] * 2)
    g = cfg.data.max_gt_boxes
    batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
             "image_hw": torch.tensor([[128.0, 128.0], [96.0, 120.0]]),
             "gt_boxes": torch.cat([boxes, torch.zeros(2, g - 3, 4)], 1),
             "gt_classes": torch.tensor([[1, 3, 2] + [0] * (g - 3)] * 2),
             "gt_valid": torch.tensor([[True] * 3 + [False] * (g - 3)] * 2)}
    runs = {}
    for device, model in ((cuda, card), ("cpu", cpu)):
        state = create_train_state(model, cfg.train, seed=None,
                                   device=device)
        _, metrics = make_train_step(model, cfg, device=device)(state, batch)
        runs[str(device)] = ({k: float(v) for k, v in metrics.items()},
                             {k: p.grad.cpu() for k, p in
                              state.params.items()})
    (m_card, g_card), (m_cpu, g_cpu) = runs[str(cuda)], runs["cpu"]
    for k, v in m_cpu.items():
        assert m_card[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    floor = 1e-6 * float(torch.stack([g.norm() for g in g_cpu.values()]).norm())
    for k, g in g_cpu.items():
        if float(g.norm()) <= floor:
            assert float(g_card[k].norm()) <= floor, k
            continue
        assert float((g_card[k] - g).norm()) <= 1e-2 * float(g.norm()), k


def test_final_nms_at_the_one_stage_shape_equals_plain(cuda):
    """RetinaNet's and FCOS's final NMS at the COCO presets' b=8 832x832
    shape: 5 levels x 1,000 unsorted candidates of 80 classes, 0.5 -> 100,
    through ``class_aware_select`` against the CPU's plain version."""
    gen = torch.Generator().manual_seed(14)
    b, n = 8, 5000
    centres = torch.rand(b, 12, 2, generator=gen) * 800
    pick = torch.randint(0, 12, (b, n), generator=gen)
    centre = torch.gather(centres, 1, pick[..., None].expand(b, n, 2))
    wh = 16 + torch.rand(b, n, 2, generator=gen) * 200
    bx = (torch.cat([centre - wh / 2, centre + wh / 2], -1)
          + torch.randn(b, n, 4, generator=gen) * 4).clamp(0, 832)
    scores = torch.rand(b, n, generator=gen)
    cls = torch.randint(1, 81, (b, n), generator=gen, dtype=torch.int32)
    valid = scores > 0.05
    ref = tk.class_aware_select(bx, scores, cls, 0.5, 100, valid_mask=valid,
                                coordinate_offset=4096.0)
    out = tk.class_aware_select(bx.to(cuda), scores.to(cuda), cls.to(cuda),
                                0.5, 100, valid_mask=valid.to(cuda),
                                coordinate_offset=4096.0)
    for got, want in zip(out, ref):
        assert torch.equal(got.cpu(), want)
    assert int(ref[2].sum()) == b * 100


def test_argmin_of_ties_on_card_takes_the_first(cuda):
    """FCOS's assignment takes the first smallest box (and index 0 where a
    point has no candidate, every area inf), as jnp.argmin: torch.argmin
    on the card does too."""
    x = torch.full((2, 14414, 100), float("inf"), device=cuda)
    x[0, :, 5] = x[0, :, 60] = x[0, :, 99] = 3.0
    assert (torch.argmin(x[0], dim=-1) == 5).all()
    assert (torch.argmin(x[1], dim=-1) == 0).all()


# ------------------------------------ ViTDet, VGG-16, Soft-NMS, TTA, weights
@pytest.mark.parametrize("name,launches", [
    ("vitdet_tiny", {"roi_align_window": 1}),
    ("maskrcnn_tiny", {"roi_align": 2})])
def test_backbone_predict_on_card_equals_plain_path(cuda, name, launches):
    """vitdet_tiny (the ViT, the simple feature pyramid and the FPN RoI
    Align) and a VGG-16 under maskrcnn_tiny's heads (c4 through the neck):
    detections on the card equal to the CPU's."""
    import dataclasses

    from tpudet_torch.cli.common import preset_config

    if name == "maskrcnn_tiny":
        cfg = preset_config(name)
        cfg = cfg.replace(backbone=dataclasses.replace(
            cfg.backbone, name="vgg16", norm="frozen_bn"))
        from tpudet_torch.models import build_model

        cpu = build_model(cfg, device="cpu").init(seed=0)
        with torch.no_grad():
            cpu.core.det_head.cls.weight.normal_(
                0, 1.0, generator=torch.Generator().manual_seed(1))
        card = build_model(cfg, device=cuda)
        card.load_state_dict(cpu.state_dict())
        batch = {"image": torch.randn(2, 128, 128, 3,
                                      generator=torch.Generator()
                                      .manual_seed(2)),
                 "image_hw": torch.tensor([[128.0, 128.0], [100.0, 120.0]])}
    else:
        _, card, cpu, batch = family_pair(cuda, name)
    counts = {"roi_align": lambda: kra.LAUNCHES,
              "roi_align_window": lambda: krw.LAUNCHES}
    before = {k: counts[k]() for k in launches}
    out = card.predict({k: v.to(cuda) for k, v in batch.items()})
    assert {k: counts[k]() - before[k] for k in launches} == launches
    ref = cpu.predict(batch)
    assert torch.equal(out["valid"].cpu(), ref["valid"])
    assert (ref["num_detections"] > 0).all()
    torch.testing.assert_close(out["boxes"].cpu(), ref["boxes"], rtol=1e-4,
                               atol=1e-3)
    torch.testing.assert_close(out["scores"].cpu(), ref["scores"], rtol=1e-4,
                               atol=1e-4)


def test_pos_embed_resize_on_card_equals_cpu(cuda):
    """The antialiased bilinear resize of the position grid, both ways,
    and its gradient, on N(0, 1) values: the card's kernel sums its taps
    in another order than the CPU's, up to 5.5e-6 apart (about 11 f32 ulps
    at the grid's largest values, ~4)."""
    from tpudet_torch.models.vit import resize_pos_embed

    pos = torch.randn(1, 64, 64, 8, generator=torch.Generator().manual_seed(3))
    for hw in ((52, 52), (52, 84), (84, 84)):
        card = pos.to(cuda).requires_grad_()
        host = pos.clone().requires_grad_()
        out, ref = resize_pos_embed(card, hw), resize_pos_embed(host, hw)
        torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-5)
        out.square().sum().backward()
        ref.square().sum().backward()
        torch.testing.assert_close(card.grad.cpu(), host.grad, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("method", ["soft_linear", "soft_gaussian"])
def test_soft_nms_on_card_equals_cpu(cuda, method):
    gen = torch.Generator().manual_seed(4)
    bx = boxes(gen, 3, 600)
    scores = torch.rand(3, 600, generator=gen)
    classes = torch.randint(1, 6, (3, 600), generator=gen, dtype=torch.int32)
    valid = torch.rand(3, 600, generator=gen) > 0.1
    kw = dict(method=method, sigma=0.5, prune_threshold=0.05,
              coordinate_offset=4096.0)
    out = tk.class_aware_select(bx.to(cuda), scores.to(cuda),
                                classes.to(cuda), 0.5, 100,
                                valid_mask=valid.to(cuda), **kw)
    ref = tk.class_aware_select(bx, scores, classes, 0.5, 100,
                                valid_mask=valid, **kw)
    assert torch.equal(out[0].cpu(), ref[0])
    assert torch.equal(out[2].cpu(), ref[2])
    torch.testing.assert_close(out[1].cpu(), ref[1], rtol=0, atol=1e-6)


def test_flip_batch_on_card_equals_cpu(cuda):
    from tpudet_torch.eval.tta import flip_batch

    gen = torch.Generator().manual_seed(5)
    image = torch.randint(0, 256, (3, 32, 48, 3), generator=gen,
                          dtype=torch.uint8)
    hw = torch.tensor([[32.0, 48.0], [20.0, 31.0], [32.0, 1.0]])
    out = flip_batch({"image": image.to(cuda), "image_hw": hw.to(cuda)})
    ref = flip_batch({"image": image, "image_hw": hw})
    assert torch.equal(out["image"].cpu(), ref["image"])


def test_backbone_weights_load_into_a_card_model(cuda):
    """``apply_backbone_weights`` into a model on the card: its backbone
    equals the converted tree."""
    import dataclasses

    import chip_smoke
    from tpudet_torch.config import tiny_test_config
    from tpudet_torch.models import build_model
    from tpudet_torch.models import import_weights as tiw

    cfg = tiny_test_config()
    cfg = cfg.replace(backbone=dataclasses.replace(
        cfg.backbone, name="resnet18", norm="frozen_bn"))
    model = build_model(cfg, device=cuda).init(0)
    params, constants = tiw.convert_torch_resnet(
        chip_smoke.torchvision_resnet_state_dict("resnet18", seed=6),
        "resnet18")
    tiw.apply_backbone_weights(model, params, constants)
    want = tiw.from_flax_variables({"params": {"backbone": params},
                                    "constants": {"backbone": constants}})
    state = model.core.state_dict()
    for k, v in want.items():
        assert state[k].is_cuda and torch.equal(state[k].cpu(), v), k


# ------------------------------------------ the tpudet:: operators (serving)
def op_cases(cuda):
    """One small input of each of the nine operators -> {name: (op, args,
    plain result)}: the plain versions' values (the gradients through
    autograd) on the same inputs."""
    gen = torch.Generator().manual_seed(31)
    b_, s_ = boxes(gen, 2, 150), torch.rand(2, 150, generator=gen)
    order = s_.argsort(1, descending=True)
    sorted_boxes = torch.gather(b_, 1, order[..., None].expand(-1, -1, 4))
    cand = torch.rand(2, 150, generator=gen) > 0.1
    pos, valid = knms.nms_keep_plain(sorted_boxes, cand, 0.5, 40)
    count = valid.sum(1).to(torch.int32)

    feat = torch.randn(2, 24, 20, 40, generator=gen)
    rois = (boxes(gen, 1, 30)[0] / 16).contiguous()
    index = torch.randint(0, 2, (30,), generator=gen, dtype=torch.int32)
    cot = torch.randn(30, 7, 7, 40, generator=gen)
    wide = feat.clone().requires_grad_()
    ref = kra.roi_align_plain(wide, rois, index, 7, 2)
    (ref_grad,) = torch.autograd.grad(ref, wide, cot)

    strides = [4.0, 8.0, 16.0, 32.0]
    maps = [torch.randn(2, s, s + 2, 24, generator=gen)
            for s in (64, 32, 16, 8)]
    fpn_rois = boxes(gen, 2, 20, extent=200.0)
    levels = fpn_assign_levels(fpn_rois, fit_window=56) - 2
    wcot = torch.randn(2, 20, 7, 7, 24, generator=gen)
    wmaps = [m.clone().requires_grad_() for m in maps]
    wref = krw.roi_align_window_plain(wmaps, strides, fpn_rois, levels, 7, 2)
    wgrads = torch.autograd.grad(wref, wmaps, wcot)

    shapes = ((12, 10), (6, 5), (3, 3))
    values, loc, weights = deform_inputs(gen, 2, 17, 4, 16, shapes, 3,
                                         torch.float32)
    dcot = torch.randn(2, 17, 4, 16, generator=gen)
    leaves = [t.clone().requires_grad_() for t in (values, loc, weights)]
    dref = kda.ms_deform_attn_plain(leaves[0], shapes, leaves[1], leaves[2])
    dgrads = torch.autograd.grad(dref, leaves, dcot)
    flat = [d for s in shapes for d in s]

    fx, fs = (torch.randn(2, 64, 5, 7, generator=gen).contiguous(
        memory_format=torch.channels_last) for _ in range(2))
    fnorm, fproj = drawn_norm(64, gen), drawn_norm(64, gen)
    fleaves = [fx.clone().requires_grad_(), fs.clone().requires_grad_()]
    fref = kfb.frozen_bn_act_plain(fleaves[0], fnorm, fleaves[1], fproj)
    fcot = torch.randn(fref.shape, generator=gen).contiguous(
        memory_format=torch.channels_last)
    fgrads = torch.autograd.grad(fref, fleaves, fcot)
    fbufs = [fnorm.scale, fnorm.bias, fnorm.mean, fnorm.var]
    pbufs = [fproj.scale, fproj.bias, fproj.mean, fproj.var]

    def on(*ts):
        return [t.to(cuda) if torch.is_tensor(t) else
                [x.to(cuda) for x in t] if isinstance(t, list)
                and t and torch.is_tensor(t[0]) else t for t in ts]

    return {
        "nms_keep": (knms.nms_keep_op, on(sorted_boxes, cand, 0.5, 40),
                     (pos, count)),
        "roi_align_fwd": (kra.roi_align_fwd, on(feat, rois, index, 7, 2),
                          (ref.detach(),)),
        "roi_align_bwd": (kra.roi_align_bwd,
                          on(cot, rois, index, list(feat.shape),
                             torch.float32, 2), (ref_grad,)),
        "roi_align_window_fwd": (krw.roi_align_window_fwd,
                                 on(maps, strides, fpn_rois, levels, 7, 2),
                                 (wref.detach(),)),
        "roi_align_window_bwd": (
            krw.roi_align_window_bwd,
            on(wcot, fpn_rois, levels, [d for m in maps for d in m.shape],
               strides, torch.float32, 2),
            (torch.cat([g.reshape(-1) for g in wgrads]),)),
        "ms_deform_attn_fwd": (kda.ms_deform_attn_fwd,
                               on(values, flat, loc, weights),
                               (dref.detach(),)),
        "ms_deform_attn_bwd": (kda.ms_deform_attn_bwd,
                               on(values, flat, loc, weights, dcot), dgrads),
        "frozen_bn_act_fwd": (kfb.frozen_bn_act_fwd,
                              on(fx, *fbufs, 1e-5, fs, pbufs, 1e-5),
                              (fref.detach(),)),
        "frozen_bn_act_bwd": (kfb.frozen_bn_act_bwd,
                              on(fcot, fref.detach(), fnorm.scale, fnorm.var,
                                 1e-5, True, [fproj.scale, fproj.var], 1e-5),
                              fgrads),
    }


OPS = ("nms_keep", "roi_align_fwd", "roi_align_bwd", "roi_align_window_fwd",
       "roi_align_window_bwd", "ms_deform_attn_fwd", "ms_deform_attn_bwd",
       "frozen_bn_act_fwd", "frozen_bn_act_bwd")


@pytest.mark.parametrize("name", OPS)
def test_tpudet_op_equals_plain(cuda, name):
    op, args, want = op_cases(cuda)[name]
    got = op(*args)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if name == "nms_keep":
            assert torch.equal(g.cpu(), w)
        else:
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", OPS)
def test_tpudet_op_passes_opcheck(cuda, name):
    op, args, _ = op_cases(cuda)[name]
    torch.library.opcheck(op, tuple(args))


def test_exported_tiny_artifact_holds_the_ops(cuda, tmp_path):
    """A tiny voc_r50-shaped (single-level) Faster R-CNN exported on the
    card: its graph calls tpudet::nms_keep and tpudet::roi_align_fwd, the
    metadata says so, and the loaded artifact launches the kernels and
    equals the live predict."""
    from tpudet_torch.config import tiny_test_config
    from tpudet_torch.data.preprocess import device_preprocess
    from tpudet_torch.models import build_model
    from tpudet_torch.serving import ServingModel, save_artifact
    from tpudet_torch.serving.export import program_ops

    cfg = tiny_test_config()
    model = build_model(cfg, device="cuda").init(0)
    path = tmp_path / "tiny.tpudet"
    meta = save_artifact(str(path), cfg, model, 2)
    assert meta["platforms"] == ["cuda"] and meta["kernels_embedded"] is True
    serving = ServingModel.load(str(path))
    assert [program_ops(p) for p in serving.programs.values()] == [
        ["nms_keep", "roi_align_fwd"]]
    gen = torch.Generator().manual_seed(0)
    image = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                          generator=gen).to(cuda)
    hw = torch.tensor([[128.0, 128.0], [100.0, 120.0]], device=cuda)
    with torch.no_grad():
        want = model.predict(device_preprocess(
            cfg, {"image": image, "image_hw": hw}))
    before = (knms.LAUNCHES, kra.LAUNCHES)
    got = serving(image, hw)
    assert (knms.LAUNCHES, kra.LAUNCHES) == (before[0] + 2, before[1] + 1)
    for key in want:
        assert torch.equal(got[key], want[key]), key


# --------------------------- frozen batch norm, residual and ReLU, one pass
@pytest.fixture
def deterministic_cudnn(cuda):
    """The same convolution algorithms on both sides of a comparison."""
    saved = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    yield cuda
    (torch.backends.cudnn.benchmark,
     torch.backends.cudnn.deterministic) = saved


def frozen_bn_case(gen, form, dtype, shape, cuda):
    """A channels-last map, its norm, the residual input and its norm (per
    ``form``) on the card."""
    def draw():
        return torch.randn(*shape, generator=gen).to(dtype).to(cuda) \
            .contiguous(memory_format=torch.channels_last)
    x = draw()
    norm = drawn_norm(shape[1], gen).to(cuda)
    residual = None if form == "plain" else draw()
    residual_norm = (drawn_norm(shape[1], gen).to(cuda)
                     if form == "projected" else None)
    return x, norm, residual, residual_norm


@pytest.mark.parametrize("c", [64, 256, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["plain", "identity", "projected"])
def test_frozen_bn_kernel_equals_plain(cuda, form, dtype, c):
    """The forward kernel against the plain ops on the card, bit for bit:
    N*H*W of 286 (no multiple of the block) and of 288, the norms far from
    the identity."""
    gen = torch.Generator().manual_seed(c + len(form))
    for shape in ((2, c, 13, 11), (3, c, 8, 12)):
        x, norm, r, rn = frozen_bn_case(gen, form, dtype, shape, cuda)
        before = kfb.LAUNCHES
        got = kfb.frozen_bn_act(x, norm, r, rn)
        assert kfb.LAUNCHES == before + 1
        want = kfb.frozen_bn_act_plain(x, norm, r, rn)
        assert got.dtype == dtype and got.stride() == x.stride()
        assert torch.equal(got, want)
        assert (want > 0).any() and (want == 0).any()


@pytest.mark.parametrize("form", ["plain", "identity", "projected"])
def test_frozen_bn_kernel_at_the_c2_size(cuda, form):
    """bf16, channels-last, [4, 256, 80, 104]: many grid-stride rounds a
    thread, with a ragged last one; forward and backward bit for bit."""
    gen = torch.Generator().manual_seed(21)
    x, norm, r, rn = frozen_bn_case(gen, form, torch.bfloat16,
                                    (4, 256, 80, 104), cuda)
    leaves = [t.clone().requires_grad_() for t in (x, r) if t is not None]
    refs = [t.clone().requires_grad_() for t in (x, r) if t is not None]
    got = kfb.frozen_bn_act(leaves[0], norm, leaves[1] if r is not None
                            else None, rn)
    want = kfb.frozen_bn_act_plain(refs[0], norm, refs[1] if r is not None
                                   else None, rn)
    assert torch.equal(got, want)
    cot = torch.randn(x.shape, generator=gen).to(torch.bfloat16).to(cuda) \
        .contiguous(memory_format=torch.channels_last)
    before = kfb.BACKWARD_LAUNCHES
    grads = torch.autograd.grad(got, leaves, cot)
    assert kfb.BACKWARD_LAUNCHES == before + 1
    for g, w in zip(grads, torch.autograd.grad(want, refs, cot)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["plain", "identity", "projected"])
def test_frozen_bn_backward_kernel_equals_autograd(cuda, form, dtype):
    """The backward kernel against autograd through the plain ops, bit for
    bit: the map's gradient and the residual input's (the identity's, or
    the projection's input through its norm); the upstream gradient comes
    NCHW-contiguous and is made channels-last."""
    gen = torch.Generator().manual_seed(5 + len(form))
    x, norm, r, rn = frozen_bn_case(gen, form, dtype, (2, 256, 13, 11), cuda)
    leaves = [t.clone().requires_grad_() for t in (x, r) if t is not None]
    refs = [t.clone().requires_grad_() for t in (x, r) if t is not None]
    second = (lambda ts: ts[1] if r is not None else None)
    got = kfb.frozen_bn_act(leaves[0], norm, second(leaves), rn)
    want = kfb.frozen_bn_act_plain(refs[0], norm, second(refs), rn)
    cot = torch.randn(x.shape, generator=gen).to(dtype).to(cuda)
    before = kfb.BACKWARD_LAUNCHES
    grads = torch.autograd.grad(got, leaves, cot)
    assert kfb.BACKWARD_LAUNCHES == before + 1
    for g, w in zip(grads, torch.autograd.grad(want, refs, cot)):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_ch,channels,stride", [(256, 256, 1),
                                                   (256, 512, 2)])
def test_bottleneck_on_card_equals_module_by_module(deterministic_cudnn,
                                                    in_ch, channels, stride,
                                                    dtype):
    """A bottleneck with an identity residual (which also feeds conv1) and
    one with a projection, on the card through the kernels, against its
    layers one by one on the card: output, input and weight gradients bit
    for bit (deterministic cuDNN on both sides)."""
    cuda = deterministic_cudnn
    gen = torch.Generator().manual_seed(channels + stride)
    block = Bottleneck(in_ch, channels, stride, "frozen_bn", dtype)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, FrozenBatchNorm):
                fresh = drawn_norm(m.scale.shape[0], gen)
                m.load_state_dict(fresh.state_dict())
            elif getattr(m, "weight", None) is not None:
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * m.weight[0].numel() ** -0.5)
    block = block.to(cuda)
    x = torch.randn(2, in_ch, 20, 26, generator=gen).to(dtype).to(cuda) \
        .contiguous(memory_format=torch.channels_last)
    xs, xw = x.clone().requires_grad_(), x.clone().requires_grad_()
    launches = (kfb.LAUNCHES, kfb.BACKWARD_LAUNCHES)
    got = block(xs)
    want = module_by_module(block, xw)
    assert torch.equal(got, want)
    cot = torch.randn(want.shape, generator=gen).to(dtype).to(cuda)
    params = list(block.parameters())
    grads = torch.autograd.grad(got, [xs, *params], cot)
    assert (kfb.LAUNCHES - launches[0],
            kfb.BACKWARD_LAUNCHES - launches[1]) == (3, 3)
    for g, w in zip(grads, torch.autograd.grad(want, [xw, *params], cot)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("stop_at,launches", [("c4", 40), ("c5", 49)])
def test_resnet50_forward_launches_the_fused_pass(cuda, stop_at, launches):
    """ResNet-50 in bf16 over a channels-last image: the stem and each of
    the bottlenecks' three norms one launch each, 40 to voc_r50's c4 and 49
    for the whole network; no launch in the module-by-module forward's
    place."""
    net = ResNet((3, 4, 6, 3), norm="frozen_bn", dtype=torch.bfloat16,
                 device=cuda)
    x = torch.randn(2, 3, 128, 160, device=cuda).contiguous(
        memory_format=torch.channels_last)
    before = kfb.LAUNCHES
    with torch.no_grad():
        feats = net(x, stop_at=stop_at)
    assert kfb.LAUNCHES - before == launches
    assert feats[stop_at].is_contiguous(memory_format=torch.channels_last)


def test_deformable_detr_r50_train_step_runs_the_backward_kernel(cuda):
    """One f32 step of the tiny Deformable DETR on a frozen-norm ResNet-50
    (the stem not frozen): 49 forward and 49 backward launches of the
    fused pass, a finite loss equal to the same step's through the plain
    layers on the card."""
    import dataclasses

    import tpudet_torch.models.resnet as resnet
    from tpudet_torch.config import tiny_deformable_detr_config
    from tpudet_torch.models import build_model
    from tpudet_torch.train.state import create_train_state
    from tpudet_torch.train.step import make_train_step

    cfg = tiny_deformable_detr_config()
    cfg = cfg.replace(backbone=dataclasses.replace(
        cfg.backbone, name="resnet50", norm="frozen_bn"))
    assert not cfg.backbone.freeze_stem
    gen = torch.Generator().manual_seed(2)
    batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
             "image_hw": torch.tensor([[128.0, 128.0], [96.0, 112.0]]),
             "gt_boxes": torch.tensor([[[10.0, 12.0, 60.0, 70.0],
                                        [0.0, 0.0, 0.0, 0.0]]] * 2),
             "gt_classes": torch.tensor([[1, 0]] * 2),
             "gt_valid": torch.tensor([[True, False]] * 2)}
    losses = []
    for fused in (True, False):
        model = build_model(cfg, device=cuda)
        state = create_train_state(model, cfg.train, seed=0, device=cuda)
        step = make_train_step(model, cfg, device=cuda)
        launches = (kfb.LAUNCHES, kfb.BACKWARD_LAUNCHES)
        if fused:
            loss = float(step(state, batch)[1]["loss"])
        else:
            saved = resnet.frozen_bn_act
            resnet.frozen_bn_act = kfb.frozen_bn_act_plain
            try:
                loss = float(step(state, batch)[1]["loss"])
            finally:
                resnet.frozen_bn_act = saved
        launched = (kfb.LAUNCHES - launches[0],
                    kfb.BACKWARD_LAUNCHES - launches[1])
        assert launched == ((49, 49) if fused else (0, 0))
        losses.append(loss)
    assert math.isfinite(losses[0])
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)


def test_frozen_bn_kernel_rejects_what_it_does_not_take(cuda):
    """Another dtype, an NCHW-contiguous map and a transposed one, a
    channels-last map of a channel count that 16-byte vectors do not
    divide, a residual of another layout; the entry passes such a map on
    to the operator, which refuses it."""
    gen = torch.Generator().manual_seed(3)
    norm = drawn_norm(64, gen).to(cuda)
    bufs = [norm.scale, norm.bias, norm.mean, norm.var]
    x = torch.randn(2, 64, 6, 10, device=cuda)
    with pytest.raises(TypeError):
        kfb.frozen_bn_act_fwd(x.half(), *bufs, 1e-5, None, [], 0.0)
    for layout in (x, x.transpose(2, 3)):
        with pytest.raises(ValueError, match="channels-last"):
            kfb.frozen_bn_act_fwd(layout, *bufs, 1e-5, None, [], 0.0)
    with pytest.raises(ValueError, match="channels-last"):
        kfb.frozen_bn_act(x, norm)
    narrow = drawn_norm(12, gen).to(cuda)
    odd = torch.randn(2, 12, 6, 10, device=cuda).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        kfb.frozen_bn_act_fwd(odd, narrow.scale, narrow.bias, narrow.mean,
                              narrow.var, 1e-5, None, [], 0.0)
    with pytest.raises(ValueError):
        kfb.frozen_bn_act_fwd(x.contiguous(memory_format=torch.channels_last),
                              *bufs, 1e-5, x, [], 0.0)
