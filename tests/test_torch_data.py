"""The port's data path against the JAX package's, on the CPU: the
synthetic dataset bit for bit for every (seed, index) and mode; VOC XML and
COCO JSON parsing on trees these tests write (PIL JPEGs); the loader's
batch plans (shuffles, aspect buckets, padded tails and their
``batch_valid``), scale-jitter factors and whole batches, all equal;
``build_dataset``; the device stream."""

import json
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch
from PIL import Image

from tpudet import config as jconfig
from tpudet.cli.common import preset_config as jax_preset
from tpudet.data import DataLoader as JDataLoader
from tpudet.data import build_dataset as jbuild
from tpudet.data import coco as jcoco
from tpudet.data import synthetic as jsyn
from tpudet.data import voc as jvoc
from tpudet_torch import config as tconfig
from tpudet_torch.cli.common import preset_config
from tpudet_torch.data import DataLoader, build_dataset
from tpudet_torch.data import coco as tcoco
from tpudet_torch.data import synthetic as tsyn
from tpudet_torch.data import voc as tvoc


def assert_examples_equal(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        if isinstance(ref[k], list):
            assert len(port[k]) == len(ref[k]), k
            for a, b in zip(port[k], ref[k]):
                np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
            assert np.asarray(port[k]).dtype == np.asarray(ref[k]).dtype, k


@pytest.mark.parametrize("mode", ["plain", "masks", "keypoints", "semantic",
                                  "all"])
def test_synthetic_dataset_bit_identical(mode):
    kw = {"plain": {}, "masks": dict(with_masks=True),
          "keypoints": dict(with_keypoints=True, num_keypoints=7),
          "semantic": dict(with_semantic=True, num_stuff_classes=2),
          "all": dict(with_masks=True, with_keypoints=True,
                      with_semantic=True)}[mode]
    for seed, classes, size in ((0, 3, 128), (1, 8, 256), (5, 20, 96)):
        port = tsyn.SyntheticDataset(classes, 40, size, 6, seed, **kw)
        ref = jsyn.SyntheticDataset(classes, 40, size, 6, seed, **kw)
        assert len(port) == len(ref)
        for i in (0, 1, 7, 39):
            assert port.example_hw(i) == ref.example_hw(i)
            assert_examples_equal(port.get_example(i), ref.get_example(i))


def write_voc(root, n=6, seed=0):
    """A VOC2007 tree under ``root``: ``n`` JPEGs of varied sizes with 1-4
    objects each (a difficult one, an unknown class, 1-based corners) and
    trainval/test splits."""
    rng = np.random.default_rng(seed)
    base = root / "VOCdevkit" / "VOC2007"
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (base / sub).mkdir(parents=True)
    ids = []
    for i in range(n):
        image_id = f"{i:06d}"
        ids.append(image_id)
        h, w = int(rng.integers(150, 500)), int(rng.integers(150, 500))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            base / "JPEGImages" / f"{image_id}.jpg")
        ann = ET.Element("annotation")
        size = ET.SubElement(ann, "size")
        ET.SubElement(size, "width").text = str(w)
        ET.SubElement(size, "height").text = str(h)
        ET.SubElement(size, "depth").text = "3"
        for j in range(int(rng.integers(1, 5))):
            obj = ET.SubElement(ann, "object")
            name = (jvoc.VOC_CLASSES[int(rng.integers(0, 20))] if j != 3
                    else "unicorn")
            ET.SubElement(obj, "name").text = name
            ET.SubElement(obj, "difficult").text = "1" if j == 1 else "0"
            bb = ET.SubElement(obj, "bndbox")
            x1, y1 = int(rng.integers(1, w // 2)), int(rng.integers(1, h // 2))
            for tag, v in (("xmin", x1), ("ymin", y1),
                           ("xmax", int(rng.integers(x1 + 1, w + 1))),
                           ("ymax", int(rng.integers(y1 + 1, h + 1)))):
                ET.SubElement(bb, tag).text = str(v)
        ET.ElementTree(ann).write(base / "Annotations" / f"{image_id}.xml")
    (base / "ImageSets/Main/trainval.txt").write_text("\n".join(ids[:4]))
    (base / "ImageSets/Main/test.txt").write_text("\n".join(ids[4:]))
    return ids


@pytest.mark.parametrize("keep_difficult", [False, True])
def test_voc_parsing_equals_jax(tmp_path, keep_difficult):
    ids = write_voc(tmp_path)
    xml = tmp_path / "VOCdevkit/VOC2007/Annotations" / f"{ids[0]}.xml"
    for a, b in zip(tvoc.parse_voc_xml(str(xml), keep_difficult),
                    jvoc.parse_voc_xml(str(xml), keep_difficult)):
        np.testing.assert_array_equal(a, b)
    assert tvoc.VOC_CLASSES == jvoc.VOC_CLASSES
    for split in ("trainval", "test"):
        port = tvoc.VOCDataset(str(tmp_path), split, keep_difficult=keep_difficult)
        ref = jvoc.VOCDataset(str(tmp_path), split, keep_difficult=keep_difficult)
        assert len(port) == len(ref) and port.num_classes == 20
        for i in range(len(ref)):
            assert port.image_id(i) == ref.image_id(i)
            assert port.example_hw(i) == ref.example_hw(i)
            assert_examples_equal(port.get_example(i), ref.get_example(i))


def write_coco(root, seed=0):
    """COCO 2017 train and val annotation files (non-contiguous category
    ids, crowd and tiny boxes, an image without annotations) and JPEGs."""
    rng = np.random.default_rng(seed)
    (root / "annotations").mkdir(parents=True)
    cats = [{"id": 7, "name": "cat"}, {"id": 2, "name": "dog"},
            {"id": 90, "name": "toaster"}]
    for split in ("train2017", "val2017"):
        (root / split).mkdir()
        images, anns = [], []
        for i in range(5):
            h, w = int(rng.integers(100, 300)), int(rng.integers(100, 300))
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(root / split / f"{i}.jpg")
            images.append({"id": 100 + i, "file_name": f"{i}.jpg",
                           "height": h, "width": w})
            for j in range(0 if i == 4 else int(rng.integers(1, 5))):
                bw = 0.5 if j == 2 else float(rng.uniform(5, w / 2))
                anns.append({
                    "id": len(anns) + 1, "image_id": 100 + i,
                    "category_id": cats[int(rng.integers(0, 3))]["id"],
                    "bbox": [float(rng.uniform(0, w / 2)),
                             float(rng.uniform(0, h / 2)), bw,
                             float(rng.uniform(5, h / 2))],
                    "iscrowd": int(j == 1),
                    **({"area": float(rng.uniform(10, 500))} if j != 3 else {}),
                })
        (root / "annotations" / f"instances_{split}.json").write_text(
            json.dumps({"images": images, "annotations": anns,
                        "categories": cats}))


@pytest.mark.parametrize("split,keep_crowd", [("train", False), ("val", True),
                                              ("val", False)])
def test_coco_parsing_equals_jax(tmp_path, split, keep_crowd):
    write_coco(tmp_path)
    port = tcoco.CocoDataset(str(tmp_path), split=split, keep_crowd=keep_crowd)
    ref = jcoco.CocoDataset(str(tmp_path), split=split, keep_crowd=keep_crowd)
    assert len(port) == len(ref)
    assert port.cat_id_to_class == ref.cat_id_to_class
    assert port.class_names == ref.class_names
    assert port.num_classes == ref.num_classes == 3
    for c in (1, 2, 3):
        assert port.category_id(c) == ref.category_id(c)
    for i in range(len(ref)):
        assert port.image_id(i) == ref.image_id(i)
        assert port.example_hw(i) == ref.example_hw(i)
        p, r = port.get_example(i), ref.get_example(i)
        # The masks and keypoints the JAX package also carries come with
        # their families; everything else is equal.
        for k in ("image", "boxes", "classes", "difficult", "crowd", "area",
                  "id"):
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)


def test_build_dataset_equals_jax(tmp_path):
    write_voc(tmp_path / "voc")
    write_coco(tmp_path / "coco")
    cases = [("synthetic", "", "train", 3), ("synthetic", "", "val", 3),
             ("voc", str(tmp_path / "voc"), "trainval", 20),
             ("voc", str(tmp_path / "voc"), "test", 20),
             ("coco", str(tmp_path / "coco"), "val", 3)]
    for dataset, data_dir, split, classes in cases:
        over = {"data.dataset": dataset, "data.data_dir": data_dir}
        port_cfg = tconfig.apply_overrides(
            tconfig.tiny_test_config(num_classes=classes), over)
        ref_cfg = jconfig.apply_overrides(
            jconfig.tiny_test_config(num_classes=classes), over)
        port, ref = build_dataset(port_cfg, split), jbuild(ref_cfg, split)
        assert type(port).__name__ == type(ref).__name__
        assert len(port) == len(ref)
        for i in (0, len(ref) - 1):
            p, r = port.get_example(i), ref.get_example(i)
            for k in ("image", "boxes", "classes"):
                np.testing.assert_array_equal(p[k], r[k])
    with pytest.raises(ValueError, match="classes"):
        build_dataset(tconfig.apply_overrides(
            tconfig.tiny_test_config(),
            {"data.dataset": "voc", "data.data_dir": str(tmp_path / "voc")}),
            "trainval")
    # nuImages is ported: a root without its version tables is refused.
    with pytest.raises(FileNotFoundError, match="v1.0-"):
        build_dataset(tconfig.apply_overrides(
            tconfig.tiny_test_config(),
            {"data.dataset": "nuimages", "data.data_dir": str(tmp_path)}))


class SizedDataset:
    """Random images of listed sizes, with 0-3 boxes each."""

    def __init__(self, sizes, seed=0):
        self.sizes = sizes
        self.seed = seed

    def __len__(self):
        return len(self.sizes)

    def example_hw(self, i):
        return self.sizes[i]

    def get_example(self, i):
        rng = np.random.default_rng([self.seed, i])
        h, w = self.sizes[i]
        n = int(rng.integers(0, 4))
        xy = rng.uniform(0, 0.6, (n, 2)) * (w, h)
        wh = rng.uniform(0.1, 0.4, (n, 2)) * (w, h)
        return {"image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                "boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
                "classes": rng.integers(1, 21, n).astype(np.int32),
                "difficult": rng.uniform(0, 1, n) < 0.3}


def loaders(port_cfg, ref_cfg, dataset, batch_size, **kw):
    return (DataLoader(port_cfg, dataset, batch_size, num_workers=2, **kw),
            JDataLoader(ref_cfg, dataset, batch_size, num_workers=2,
                        process_index=0, process_count=1, **kw))


def plans_equal(port, ref, epoch):
    p, r = port._epoch_batch_indices(epoch), ref._epoch_batch_indices(epoch)
    assert len(p) == len(r)
    for (pi, pv), (ri, rv) in zip(p, r):
        np.testing.assert_array_equal(pi, ri)
        assert (pv is None) == (rv is None)
        if rv is not None:
            np.testing.assert_array_equal(pv, rv)


VOC_SIZES = [(375, 500), (500, 375), (333, 500), (480, 640), (640, 427),
             (281, 500), (500, 500), (200, 700), (700, 200), (427, 640)]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_plans_equal_jax(shuffle, drop_last):
    sizes = [VOC_SIZES[i % len(VOC_SIZES)] for i in range(37)]
    dataset = SizedDataset(sizes)
    port, ref = loaders(preset_config("voc_r50"), jax_preset("voc_r50"),
                        dataset, 4, shuffle=shuffle, drop_last=drop_last,
                        seed=3)
    assert len(port) == len(ref)
    for epoch in (0, 1, 5):
        plans_equal(port, ref, epoch)
    if not drop_last:
        assert any(v is not None for _, v in port._epoch_batch_indices(0))
    # One canvas for everything: the plain shuffled order in batches.
    port, ref = loaders(tconfig.tiny_test_config(), jconfig.tiny_test_config(),
                        dataset, 5, shuffle=shuffle, drop_last=drop_last,
                        seed=3)
    for epoch in (0, 2):
        plans_equal(port, ref, epoch)


def test_loader_jitter_factors_and_batches_equal_jax():
    port_cfg = tconfig.apply_overrides(preset_config("voc_r50"),
                                       {"data.scale_jitter": (0.8, 1.2)})
    ref_cfg = jconfig.apply_overrides(jax_preset("voc_r50"),
                                      {"data.scale_jitter": (0.8, 1.2)})
    dataset = SizedDataset([VOC_SIZES[i % 4] for i in range(11)], seed=1)
    port, ref = loaders(port_cfg, ref_cfg, dataset, 3, drop_last=False,
                        augment=True, seed=2)
    for epoch, i in ((0, 0), (0, 7), (3, 2)):
        assert port._jitter_factor(epoch, i) == ref._jitter_factor(epoch, i)
    assert port._jitter_factor(0, 1) != 1.0
    for epoch in (0, 1):
        p_batches, r_batches = list(port.batches(epoch)), list(ref.batches(epoch))
        assert len(p_batches) == len(r_batches) == len(ref)
        for p, r in zip(p_batches, r_batches):
            assert set(p) == set(r)
            for k in r:
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
                assert p[k].dtype == r[k].dtype, k
    assert any("batch_valid" in b for b in p_batches)


def test_loader_synthetic_batches_equal_jax():
    cfg, ref_cfg = tconfig.tiny_test_config(), jconfig.tiny_test_config()
    dataset = tsyn.SyntheticDataset(3, num_examples=12)
    port, ref = loaders(cfg, ref_cfg, dataset, 4, augment=True)
    for p, r in zip(port.batches(0), ref.batches(0)):
        for k in r:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)


def test_loader_guards():
    cfg = tconfig.tiny_test_config()
    dataset = tsyn.SyntheticDataset(3, num_examples=4)
    with pytest.raises(ValueError, match="fewer than"):
        DataLoader(cfg, dataset, 8)
    # The global batch splits evenly over the processes (tpudet's message).
    with pytest.raises(ValueError, match="not divisible by process_count"):
        DataLoader(cfg, dataset, 3, process_index=1, process_count=2)
    with pytest.raises(ValueError, match="outside"):
        DataLoader(cfg, dataset, 2, process_index=2, process_count=2)
    # The native decoder reads JPEG bytes: a dataset without get_raw has none.
    with pytest.raises(ValueError, match="get_raw"):
        DataLoader(tconfig.apply_overrides(cfg, {"data.decoder": "native"}),
                   dataset, 2)
    voc = preset_config("voc_r50")
    with pytest.raises(ValueError, match="zero batches"):
        DataLoader(voc, SizedDataset([(375, 500), (500, 375)] * 2), 3)


def test_device_stream_on_cpu_matches_batches_and_surfaces_errors():
    cfg = tconfig.tiny_test_config()
    loader = DataLoader(cfg, tsyn.SyntheticDataset(3, num_examples=6), 2,
                        num_workers=2)
    stream = loader.device_stream("cpu")
    host = list(loader.batches(0)) + list(loader.batches(1))[:1]
    for want in host:
        got = next(stream)
        for k, v in want.items():
            assert isinstance(got[k], torch.Tensor)
            np.testing.assert_array_equal(got[k].numpy(), v)
    stream.close()

    class Broken(SizedDataset):
        def get_example(self, i):
            raise OSError("unreadable image")

    stream = DataLoader(cfg, Broken([(64, 64)] * 4), 2).device_stream("cpu")
    with pytest.raises(RuntimeError, match="producer") as info:
        next(stream)
    assert isinstance(info.value.__cause__, OSError)
