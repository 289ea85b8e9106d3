"""The port's nuImages dataset (``tpudet_torch/data/nuimages.py``) against
``tpudet.data.nuimages`` on the JAX package's own table fixture: the same
examples, raw records and loader batches."""

import numpy as np
import pytest

from tests.test_data import _write_nuimages_fixture
from tpudet import config as jconfig
from tpudet.data import DataLoader as JDataLoader
from tpudet.data import build_dataset as jbuild_dataset
from tpudet.data.nuimages import NuImagesDataset as JNuImages
from tpudet_torch import config as tconfig
from tpudet_torch.data import DataLoader, build_dataset
from tpudet_torch.data.nuimages import NuImagesDataset


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("nuimages")
    _write_nuimages_fixture(path)
    return path


def same_record(port, ref):
    assert set(port) == set(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert port[key].dtype == value.dtype, key
            np.testing.assert_array_equal(port[key], value, err_msg=key)
        else:
            assert port[key] == value, key


@pytest.mark.parametrize("split", ["train", "val"])
def test_examples_equal_jax(root, split):
    port, ref = NuImagesDataset(str(root), split), JNuImages(str(root), split)
    assert len(port) == len(ref) == {"train": 1, "val": 2}[split]
    assert port.class_names == ref.class_names
    assert port.num_classes == ref.num_classes == 3
    for i in range(len(ref)):
        assert port.image_id(i) == ref.image_id(i)
        assert port.example_hw(i) == ref.example_hw(i) == (48, 64)
        same_record(port.get_example(i), ref.get_example(i))
        same_record(port.get_raw(i), ref.get_raw(i))
    with pytest.raises(FileNotFoundError, match="v1.0-"):
        NuImagesDataset(str(root), split="v1.0-missing")


def test_loader_batches_equal_jax(root):
    fields = dict(dataset="nuimages", data_dir=str(root), num_classes=3,
                  min_size=48, max_size=64, canvas_height=64, canvas_width=64)
    cfg = tconfig.Config(data=tconfig.DataConfig(decoder="pil", **fields))
    jcfg = jconfig.Config(data=jconfig.DataConfig(**fields))
    ds, jds = build_dataset(cfg, "val"), jbuild_dataset(jcfg, "val")
    assert type(ds) is NuImagesDataset and len(ds) == len(jds) == 2
    batch = next(DataLoader(cfg, ds, batch_size=2, shuffle=False,
                            drop_last=False, num_workers=1).batches(0))
    ref = next(JDataLoader(jcfg, jds, batch_size=2, shuffle=False,
                           drop_last=False, num_workers=1, process_index=0,
                           process_count=1).batches(0))
    assert batch["image"].shape[0] == 2
    arrays = {k for k, v in ref.items() if isinstance(v, np.ndarray)}
    assert "gt_boxes" in arrays and arrays <= set(batch)
    for key in arrays:
        np.testing.assert_array_equal(np.asarray(batch[key]), ref[key],
                                      err_msg=key)
    with pytest.raises(ValueError, match="3 classes.*num_classes.*80"):
        build_dataset(tconfig.Config(data=tconfig.DataConfig(
            dataset="nuimages", data_dir=str(root), num_classes=80)), "val")
