"""The port's export CLI (``tpudet_torch/cli/export.py``, as
``tests/test_cli.py`` and ``tests/test_serving.py`` hold tpudet's), the
``tpudet::`` operators' fake bodies (what ``torch.export`` traces on the
card) against the plain versions' outputs at the main paths' shapes, and
the static plain FPN pooler under ``torch.export``, on the CPU."""

import pytest
import torch

from tpudet_torch.cli.export import main as export_main
from tpudet_torch.config import apply_overrides, tiny_test_config
from tpudet_torch.data.preprocess import device_preprocess
from tpudet_torch.kernels import deform_attn as kda
from tpudet_torch.kernels import nms as knms
from tpudet_torch.kernels import roi_align as kra
from tpudet_torch.kernels import roi_align_window as krw
from tpudet_torch.models import build_model
from tpudet_torch.ops.roi_align import roi_align_levels
from tpudet_torch.serving import ServingModel
from tpudet_torch.train.checkpoint import CheckpointManager
from tpudet_torch.train.state import create_train_state

# The tiny preset keeps 32 proposals before its NMS (a small exported
# graph: the plain NMS's loop unrolls in it).
SMALL = ["--set", "rpn.pre_nms_topk_test=32", "--set",
         "rpn.post_nms_topk_test=16", "--device", "cpu"]


def test_export_cli_verify(tmp_path, capsys):
    path = tmp_path / "cli_model.tpudet"
    meta = export_main(["--preset", "tiny", "--output", str(path),
                        "--batch-size", "1", "--verify", *SMALL])
    out = capsys.readouterr().out
    assert "RANDOMLY INITIALIZED" in out and "verify: ok" in out
    assert meta["platforms"] == ["cpu"] and meta["batch_size"] == 1
    assert meta["kernels_embedded"] is False
    assert ServingModel.load(str(path)).batch_size == 1


def test_export_cli_restores_the_checkpoint(tmp_path):
    cfg = apply_overrides(tiny_test_config(), {
        "rpn.pre_nms_topk_test": 32, "rpn.post_nms_topk_test": 16})
    model = build_model(cfg, device="cpu")
    state = create_train_state(model, cfg.train, seed=5, device="cpu")
    CheckpointManager(str(tmp_path / "ckpt")).save(state, force=True)
    path = tmp_path / "restored.tpudet"
    export_main(["--preset", "tiny", "--output", str(path), "--batch-size",
                 "1", "--checkpoint-dir", str(tmp_path / "ckpt"), *SMALL])
    gen = torch.Generator().manual_seed(0)
    image = torch.randint(0, 256, (1, 128, 128, 3), dtype=torch.uint8,
                          generator=gen)
    hw = torch.tensor([[128.0, 100.0]])
    with torch.no_grad():
        want = model.predict(device_preprocess(
            cfg, {"image": image, "image_hw": hw}))
    got = ServingModel.load(str(path))(image, hw)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_export_refuses_empty_checkpoint_dir(tmp_path):
    (tmp_path / "empty_ckpt").mkdir()
    with pytest.raises(SystemExit, match="no checkpoint found"):
        export_main(["--preset", "tiny", "--checkpoint-dir",
                     str(tmp_path / "empty_ckpt"), "--output",
                     str(tmp_path / "m.tpudet"), "--batch-size", "1",
                     "--device", "cpu"])
    assert not (tmp_path / "m.tpudet").exists()


# (The ids keep "tpu" out of the test names: the suite's conftest skips
# those without a TPU.)
@pytest.mark.parametrize("platforms", ["tpu", "cuda,cpu"],
                         ids=["foreign", "two"])
def test_export_cli_refuses_other_platforms(tmp_path, capsys, platforms):
    with pytest.raises(SystemExit) as info:
        export_main(["--preset", "tiny", "--output", str(tmp_path / "m"),
                     "--platforms", platforms])
    assert info.value.code == 2
    assert "exactly one of" in capsys.readouterr().err


# ------------------------------------------------ the operators' fake bodies
META = "meta"


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


# NMS calls: voc_r50's proposals (8 x 6,000 presorted at 0.7 -> 300) and
# final select (8 x 1,024 at 0.5 -> 100), coco_r101_fpn's proposals (8 x
# 4,608 at 0.7 -> 300).
@pytest.mark.parametrize("b,p,thr,k", [(8, 6000, 0.7, 300),
                                       (8, 1024, 0.5, 100),
                                       (8, 4608, 0.7, 300)])
def test_nms_keep_fake_shapes(b, p, thr, k):
    boxes, cand = meta(b, p, 4), meta(b, p, dtype=torch.bool)
    positions, count = knms.nms_keep_op(boxes, cand, thr, k)
    assert (count.shape, count.dtype) == ((b,), torch.int32)
    valid = torch.arange(k, device=META)[None, :] < count[:, None]
    plain = knms.nms_keep_plain(boxes, cand, thr, k)
    for got, want in zip((positions, valid), plain):
        assert (got.shape, got.dtype) == (want.shape, want.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_align_fake_shapes(dtype):
    """voc_r50: c4 [8, 40, 40, 256] x 300 RoIs per image at S = 7."""
    feat = meta(8, 40, 40, 256, dtype=dtype, grad=True)
    boxes, index = meta(2400, 4), meta(2400, dtype=torch.int32)
    out = kra.roi_align_fwd(feat, boxes, index, 7, 2)
    plain = kra.roi_align_plain(feat, boxes, index, 7, 2)
    assert (out.shape, out.dtype) == (plain.shape, plain.dtype)
    grad = kra.roi_align_bwd(plain.detach(), boxes, index,
                             list(feat.shape), dtype, 2)
    (want,) = torch.autograd.grad(plain, feat, torch.empty_like(plain))
    assert (grad.shape, grad.dtype) == (want.shape, want.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_align_window_fake_shapes(dtype):
    """coco_r101_fpn: p2..p5 of the 832x832 pyramid, 300 RoIs per image."""
    maps = [meta(8, s, s, 256, dtype=dtype, grad=True)
            for s in (208, 104, 52, 26)]
    strides = [4.0, 8.0, 16.0, 32.0]
    boxes, levels = meta(8, 300, 4), meta(8, 300, dtype=torch.int32)
    out = krw.roi_align_window_fwd(maps, strides, boxes, levels, 7, 2)
    plain = krw.roi_align_window_plain(maps, strides, boxes, levels, 7, 2)
    assert (out.shape, out.dtype) == (plain.shape, plain.dtype)
    flat = krw.roi_align_window_bwd(
        plain.detach(), boxes, levels,
        [d for m in maps for d in m.shape], strides, dtype, 2)
    wants = torch.autograd.grad(plain, maps, torch.empty_like(plain))
    assert flat.dtype == dtype
    assert flat.shape == (sum(w.numel() for w in wants),)
    assert all(w.dtype == dtype for w in wants)


@pytest.mark.parametrize("queries", [14365, 300])
def test_ms_deform_attn_fake_shapes(queries):
    """coco_deformable_detr_r50 at 832x832: an encoder layer (Q = N) and a
    decoder layer (Q = 300), 8 heads of 32, 4 levels x 4 points, bf16."""
    shapes = ((104, 104), (52, 52), (26, 26), (13, 13))
    n = sum(h * w for h, w in shapes)
    values = meta(8, n, 8, 32, dtype=torch.bfloat16, grad=True)
    loc = meta(8, queries, 8, 4, 4, 2, grad=True)
    weights = meta(8, queries, 8, 4, 4, grad=True)
    flat = [d for s in shapes for d in s]
    out = kda.ms_deform_attn_fwd(values, flat, loc, weights)
    plain = kda.ms_deform_attn_plain(values, shapes, loc, weights)
    assert (out.shape, out.dtype) == (plain.shape, plain.dtype)
    grads = kda.ms_deform_attn_bwd(values, flat, loc, weights,
                                   plain.detach())
    wants = torch.autograd.grad(plain, (values, loc, weights),
                                torch.empty_like(plain))
    for got, want in zip(grads, wants):
        assert (got.shape, got.dtype) == (want.shape, want.dtype)


# ------------------------------------------------- the static plain pooler
class Pool(torch.nn.Module):
    def forward(self, p2, p3, p4, p5, boxes, levels):
        return roi_align_levels([p2, p3, p4, p5], [4.0, 8.0, 16.0, 32.0],
                                boxes, levels, 7, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_pooler_exports_exactly(dtype):
    gen = torch.Generator().manual_seed(0)
    maps = [torch.randn(2, s, s + 3, 8, generator=gen).to(dtype)
            for s in (32, 16, 8, 4)]
    xy = torch.rand(2, 40, 2, generator=gen) * 150 - 10
    boxes = torch.cat([xy, xy + torch.rand(2, 40, 2, generator=gen) * 90], -1)
    levels = torch.randint(-1, 5, (2, 40), generator=gen, dtype=torch.int32)
    args = (*maps, boxes, levels)
    program = torch.export.export(Pool(), args, strict=False)
    assert not [n for n in program.graph.nodes if "nonzero" in str(n.target)]
    want = Pool()(*args)
    assert torch.equal(program.module()(*args), want)
    # A level naming no map pools to zeros.
    outside = (levels < 0) | (levels > 3)
    assert outside.any() and (want[outside] == 0).all()
    assert (want[~outside] != 0).any()
