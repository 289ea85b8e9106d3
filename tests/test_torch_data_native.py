"""The port's native data path against the JAX package's, on the CPU:
``prepare_example_jpeg`` (buckets, the scale jitter, DCT scaling on and
off), the datasets' ``get_raw`` on VOC and COCO trees these tests write,
and the loader's batches under each ``data.decoder``; its guards and the
per-image fallback of a JPEG that libjpeg rejects (CMYK)."""

import dataclasses
import io
import sys

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_data import write_coco, write_voc
from tpudet import config as jconfig
from tpudet.cli.common import preset_config as jax_preset
from tpudet.data import DataLoader as JDataLoader
from tpudet.data import coco as jcoco
from tpudet.data import voc as jvoc
from tpudet.data.preprocess import prepare_example_jpeg as jax_prepare_jpeg
from tpudet_torch import config as tconfig
from tpudet_torch.cli.common import preset_config
from tpudet_torch.data import DataLoader, SyntheticDataset
from tpudet_torch.data import coco as tcoco
from tpudet_torch.data import voc as tvoc
from tpudet_torch.data.native_decode import NativeDecodeError
from tpudet_torch.data.preprocess import prepare_example_jpeg


def photo_jpeg(rng, h, w, quality=90):
    small = rng.integers(0, 255, (max(2, h // 8), max(2, w // 8), 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
        buf, format="JPEG", quality=quality)
    return buf.getvalue()


def data_configs(**kw):
    return (dataclasses.replace(tconfig.DataConfig(), **kw),
            dataclasses.replace(jconfig.DataConfig(), **kw))


def assert_examples_equal(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        assert port[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("case", ["square canvas", "aspect buckets",
                                  "orientation buckets", "scale jitter",
                                  "jitter in buckets"])
def test_prepare_example_jpeg_equals_jax(case, fast):
    rng = np.random.default_rng(len(case))
    kw = dict(min_size=96, max_size=160, canvas_height=160, canvas_width=160,
              max_gt_boxes=4, fast_jpeg_scale=fast)
    if "bucket" in case:
        kw["aspect_buckets"] = ((96, 96), (96, 128), (128, 96))
    if case == "orientation buckets":
        kw.update(aspect_buckets=(), orientation_buckets=True,
                  canvas_short=112)
    factor = 0.83 if "jitter" in case else 1.0
    port_cfg, ref_cfg = data_configs(**kw)
    boxes = np.asarray([[10, 20, 200, 180], [0, 0, 50, 60], [5, 5, 9, 9],
                        [1, 2, 3, 4], [7, 7, 70, 70]], np.float32)
    classes = np.asarray([1, 2, 3, 1, 2], np.int32)
    difficult = np.asarray([0, 1, 0, 0, 1], bool)
    for h, w in [(300, 400), (140, 90), (100, 100), (217, 333)]:
        data = photo_jpeg(rng, h, w)
        got = prepare_example_jpeg(port_cfg, data, boxes, classes,
                                   difficult=difficult, scale_factor=factor)
        want = jax_prepare_jpeg(ref_cfg, data, boxes, classes,
                                difficult=difficult, scale_factor=factor)
        assert_examples_equal(got, want)


def test_get_raw_equals_jax(tmp_path):
    write_voc(tmp_path / "voc")
    for split in ("trainval", "test"):
        port = tvoc.VOCDataset(str(tmp_path / "voc"), split,
                               keep_difficult=True)
        ref = jvoc.VOCDataset(str(tmp_path / "voc"), split,
                              keep_difficult=True)
        for i in range(len(ref)):
            p, r = port.get_raw(i), ref.get_raw(i)
            assert set(p) == set(r) and p["jpeg"] == r["jpeg"]
            for k in ("boxes", "classes", "difficult", "id"):
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    write_coco(tmp_path / "coco")
    for split in ("train", "val"):
        port = tcoco.CocoDataset(str(tmp_path / "coco"), split=split)
        ref = jcoco.CocoDataset(str(tmp_path / "coco"), split=split)
        for i in range(len(ref)):
            p, r = port.get_raw(i), ref.get_raw(i)
            assert set(p) == set(r) and p["jpeg"] == r["jpeg"]
            for k in ("boxes", "classes", "difficult", "crowd", "area", "id"):
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)


def voc_loaders(root, decoder, **kw):
    """The port's and the JAX package's loaders over the VOC tree at
    ``root`` (the voc_r50 preset's buckets, shrunk 5x) with ``decoder``."""
    over = {"data.dataset": "voc", "data.decoder": decoder,
            "data.min_size": 120, "data.max_size": 200,
            "data.aspect_buckets": ((128, 128), (128, 160), (160, 128)),
            **kw}
    port_cfg = tconfig.apply_overrides(preset_config("voc_r50"), over)
    ref_cfg = jconfig.apply_overrides(jax_preset("voc_r50"), over)
    port = DataLoader(port_cfg, tvoc.VOCDataset(str(root), "trainval"), 2,
                      shuffle=True, num_workers=2, drop_last=False,
                      augment=True)
    ref = JDataLoader(ref_cfg, jvoc.VOCDataset(str(root), "trainval"), 2,
                      shuffle=True, num_workers=2, drop_last=False,
                      augment=True, process_index=0, process_count=1)
    return port, ref


@pytest.mark.parametrize("decoder", ["native", "auto", "pil"])
def test_loader_batches_equal_jax(tmp_path, decoder):
    write_voc(tmp_path, n=10)
    (tmp_path / "VOCdevkit/VOC2007/ImageSets/Main/trainval.txt").write_text(
        "\n".join(f"{i:06d}" for i in range(10)))
    port, ref = voc_loaders(tmp_path, decoder,
                            **{"data.scale_jitter": (0.8, 1.2)})
    assert port.native_decode == ref.native_decode == (decoder != "pil")
    n = 0
    for epoch in (0, 1):
        for p, r in zip(port.batches(epoch), ref.batches(epoch)):
            assert set(p) == set(r)
            for k in r:
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
            n += 1
    assert n == 2 * len(ref)


def test_loader_decoder_guards():
    cfg = tconfig.tiny_test_config()
    synthetic = SyntheticDataset(3, num_examples=4)
    with pytest.raises(ValueError, match="unknown data.decoder"):
        DataLoader(tconfig.apply_overrides(cfg, {"data.decoder": "PIL"}),
                   synthetic, 2)
    with pytest.raises(ValueError, match="get_raw"):
        DataLoader(tconfig.apply_overrides(cfg, {"data.decoder": "native"}),
                   synthetic, 2)
    # "auto" on a dataset without JPEGs decodes as before.
    assert not DataLoader(cfg, synthetic, 2).native_decode


def write_cmyk(root, image_id):
    """Replace one VOC image by a CMYK JPEG (libjpeg will not make RGB of
    it; PIL does)."""
    path = root / "VOCdevkit/VOC2007/JPEGImages" / f"{image_id}.jpg"
    rgb = Image.open(path).convert("RGB")
    rgb.convert("CMYK").save(path, format="JPEG", quality=90)
    return path


def test_cmyk_jpeg_falls_back_per_image(tmp_path, capsys):
    ids = write_voc(tmp_path, n=6)
    write_cmyk(tmp_path, ids[1])
    port, ref = voc_loaders(tmp_path, "native")
    with pytest.raises(NativeDecodeError):
        prepare_example_jpeg(port.cfg.data, port.dataset.get_raw(1)["jpeg"],
                             np.zeros((0, 4), np.float32),
                             np.zeros(0, np.int32))
    for p, r in zip(port.batches(0), ref.batches(0)):
        for k in r:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    assert f"rejected image '{ids[1]}'" in capsys.readouterr().out


def test_cmyk_fallback_without_pil_names_the_image(tmp_path, monkeypatch):
    ids = write_voc(tmp_path, n=4)
    path = write_cmyk(tmp_path, ids[2])
    port, _ = voc_loaders(tmp_path, "native")
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL fails
    with pytest.raises(ImportError, match=str(path)):
        list(port.batches(0))
