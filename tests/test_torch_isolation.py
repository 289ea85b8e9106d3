"""The port stands alone: importing it loads neither JAX nor TensorFlow
nor any module of the JAX package or of ``scripts/`` (whose probe imports
JAX), nor does ``chip_smoke.py``; and its config keeps the JAX package's
defaults."""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest

from tests.test_torch_ops import PORT_ONLY_FIELDS, assert_group_equals_jax
from tpudet import config as jconfig
from tpudet_torch import config as tconfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "tpudet_torch"
# Top-level names neither the port nor chip_smoke.py may import.
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "tpudet", "scripts",
          "tensorflow", "keras")


def test_import_loads_no_jax_and_no_tpudet_module():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import tpudet_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tpudet_torch.__path__,"
        " 'tpudet_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "print(json.dumps({'modules': names, 'loaded': sorted(sys.modules)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(result["modules"]) >= 20
    # The data-parallel group, Mask R-CNN, the backbones' and the serving
    # slices are walked too.
    for name in NEW_MODULES + BACKBONE_MODULES + SERVING_MODULES:
        assert name in result["modules"], name
    assert not [m for m in result["loaded"] if m.split(".")[0] in BANNED]


# The modules of the data-parallel and Mask R-CNN slice and of the tensor-
# parallel one, and the top-level names they may import: the standard
# library, numpy, PIL (the polygon raster), torch, and the port;
# torch.distributed is the one new torch package among them.
NEW_MODULES = ("tpudet_torch.parallel", "tpudet_torch.parallel.mesh",
               "tpudet_torch.parallel.sharding_rules",
               "tpudet_torch.models.mask_rcnn", "tpudet_torch.models.mask_head",
               "tpudet_torch.ops.masks", "tpudet_torch.data.masks")
NEW_IMPORTS = {"__future__", "dataclasses", "datetime", "os", "typing",
               "numpy", "PIL", "torch", "tpudet_torch"}


def test_new_modules_import_torch_distributed_and_nothing_else_new():
    found = set()
    for name in NEW_MODULES:
        rel = name.replace(".", "/")
        path = ROOT / (rel + ".py")
        if not path.exists():
            path = ROOT / rel / "__init__.py"
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                found.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                found.add(node.module or "")
    roots = {n.split(".")[0] for n in found}
    assert roots <= NEW_IMPORTS, roots - NEW_IMPORTS
    torch_packages = {n for n in found if n.startswith("torch.")}
    assert torch_packages <= {"torch.distributed", "torch.nn.functional"}
    assert "torch.distributed" in found


# The modules of the backbones' slice (ViTDet, VGG-16, the converters,
# TTA) and the top-level names they may import: no TensorFlow (the Keras
# converters read the model's layers by duck typing), and no torch package
# beyond torch.nn.functional.
BACKBONE_MODULES = ("tpudet_torch.models.vit", "tpudet_torch.models.vgg",
                    "tpudet_torch.models.import_weights",
                    "tpudet_torch.eval.tta")
BACKBONE_IMPORTS = {"__future__", "math", "typing", "numpy", "torch",
                    "tpudet_torch"}


@pytest.mark.parametrize("name", BACKBONE_MODULES)
def test_backbone_modules_import_nothing_new(name):
    path = ROOT / (name.replace(".", "/") + ".py")
    found = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            found.add(node.module or "")
    assert {n.split(".")[0] for n in found} <= BACKBONE_IMPORTS, found
    assert {n for n in found if n.startswith("torch.")} <= {
        "torch.nn.functional"}


# The modules of the serving slice: the artifact and its loader, the
# kernels' operator namespace, the export and parity CLIs, nuImages.
SERVING_MODULES = ("tpudet_torch.serving", "tpudet_torch.serving.export",
                   "tpudet_torch.kernels._ops", "tpudet_torch.cli.export",
                   "tpudet_torch.cli.parity", "tpudet_torch.data.nuimages")


def test_serving_import_loads_no_model_code_and_builds_nothing():
    """What a serving process loads: ``import tpudet_torch.serving`` brings
    neither JAX, tpudet nor the port's model code, and registering the
    kernels' operators builds and loads no library (no nvcc)."""
    code = (
        "import json, sys\n"
        "import tpudet_torch.serving\n"
        "from tpudet_torch.kernels import _build\n"
        "print(json.dumps({'loaded': sorted(sys.modules),"
        " 'built': sorted(_build._loaded)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "CUDA_HOME": "/none"})
    result = json.loads(out.stdout.strip().splitlines()[-1])
    loaded = result["loaded"]
    assert "tpudet_torch.serving.export" in loaded
    assert "tpudet_torch.kernels.roi_align_window" in loaded
    assert not [m for m in loaded if m.startswith("tpudet_torch.models")]
    assert not [m for m in loaded if m.split(".")[0] in BANNED]
    assert result["built"] == []


def test_sources_import_no_jax_and_no_tpudet():
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BANNED, \
                    f"{path.relative_to(ROOT)} imports {name}"


# Each group's class name -> its field of ``Config`` (``PORT_ONLY_FIELDS``
# are keyed by the field).
GROUPS = {type(getattr(tconfig.Config(), f.name)).__name__: f.name
          for f in dataclasses.fields(tconfig.Config)
          if dataclasses.is_dataclass(getattr(tconfig.Config(), f.name))}


@pytest.mark.parametrize("group", ["DataConfig", "BackboneConfig",
                                   "AnchorConfig", "RPNConfig", "ROIConfig",
                                   "RetinaNetConfig", "FCOSConfig",
                                   "DETRConfig",
                                   "DeformableDETRConfig", "MaskConfig",
                                   "CascadeConfig", "KeypointConfig",
                                   "PanopticConfig", "TrainConfig",
                                   "EvalConfig", "Config"])
def test_config_defaults_equal_jax(group):
    port = getattr(tconfig, group)()
    ref = getattr(jconfig, group)()
    key = GROUPS.get(group, "")
    fields = [f.name for f in dataclasses.fields(port)
              if f"{key}.{f.name}" not in PORT_ONLY_FIELDS]
    for name in fields:
        assert hasattr(ref, name), f"{group}.{name} is not a JAX field"
        if group != "Config" or name in ("model", "use_pallas", "rpn_only",
                                         "det_only"):
            assert getattr(port, name) == getattr(ref, name), f"{group}.{name}"
    # ... and the other way: every JAX field exists in the port, with the
    # JAX default, so that ``--set`` takes every field tpudet takes.
    for name in (f.name for f in dataclasses.fields(ref)):
        assert hasattr(port, name), f"{group}.{name} is missing in the port"
        if group != "Config":
            assert getattr(port, name) == getattr(ref, name), f"{group}.{name}"


def test_no_option_raises_not_implemented():
    """Every option the JAX package supports is ported: no source of the
    port raises ``NotImplementedError``."""
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc.func if isinstance(node.exc, ast.Call) \
                    else node.exc
                assert getattr(exc, "id", None) != "NotImplementedError", (
                    f"{path.relative_to(ROOT)}:{node.lineno}")


# The fields the FPN slice reads: present in the port, with JAX's defaults.
FPN_FIELDS = {
    "BackboneConfig": ("use_fpn",),
    "AnchorConfig": ("fpn_strides", "fpn_scales", "fpn_octave_scales",
                     "num_fpn_anchors_per_cell"),
    "RPNConfig": ("fpn_pre_nms_topk_per_level_test", "topk_method",
                  "topk_block_size"),
    "ROIConfig": ("pooler", "window"),
}
# ... and the backbones' slice: the ViT's knobs and the final selections'
# method.
BACKBONE_FIELDS = {
    "BackboneConfig": ("vit_window", "vit_global_attn_every",
                       "vit_pos_grid"),
    "ROIConfig": ("nms_method", "soft_nms_sigma"),
    "RetinaNetConfig": ("nms_method", "soft_nms_sigma"),
    "FCOSConfig": ("nms_method", "soft_nms_sigma"),
}


@pytest.mark.parametrize("group", sorted(BACKBONE_FIELDS))
def test_backbone_config_fields_equal_jax(group):
    port = getattr(tconfig, group)()
    ref = getattr(jconfig, group)()
    for name in BACKBONE_FIELDS[group]:
        assert getattr(port, name) == getattr(ref, name), f"{group}.{name}"


@pytest.mark.parametrize("group", sorted(FPN_FIELDS))
def test_fpn_config_fields_equal_jax(group):
    port = getattr(tconfig, group)()
    ref = getattr(jconfig, group)()
    for name in FPN_FIELDS[group]:
        assert getattr(port, name) == getattr(ref, name), f"{group}.{name}"


def test_tiny_test_config_equals_jax_fields():
    for use_fpn in (False, True):
        port = tconfig.tiny_test_config(use_fpn=use_fpn)
        ref = jconfig.tiny_test_config(use_fpn=use_fpn)
        for group in ("data", "backbone", "anchors", "rpn", "roi", "train"):
            assert_group_equals_jax(port, ref, group)
        assert port.use_pallas == ref.use_pallas


def test_tiny_deformable_detr_config_equals_jax_fields():
    port = tconfig.tiny_deformable_detr_config()
    ref = jconfig.tiny_deformable_detr_config()
    assert port.model == ref.model == "deformable_detr"
    for group in ("data", "backbone", "deformable_detr", "train"):
        assert_group_equals_jax(port, ref, group)
    # Every JAX field of the group is in the port.
    assert ({f.name for f in dataclasses.fields(ref.deformable_detr)}
            == {f.name for f in dataclasses.fields(port.deformable_detr)})


def test_tiny_maskrcnn_config_equals_jax_fields():
    port = tconfig.tiny_maskrcnn_config()
    ref = jconfig.tiny_maskrcnn_config()
    assert port.model == ref.model == "mask_rcnn"
    for group in ("data", "backbone", "anchors", "rpn", "roi", "mask",
                  "train"):
        assert_group_equals_jax(port, ref, group)
    assert ({f.name for f in dataclasses.fields(ref.mask)}
            == {f.name for f in dataclasses.fields(port.mask)})


@pytest.mark.parametrize("name", ["coco_r50", "coco_maskrcnn_r50_fpn",
                                  "maskrcnn_tiny", "cascade_tiny",
                                  "coco_cascade_r50_fpn", "keypoint_tiny",
                                  "coco_keypoint_r50_fpn", "panoptic_tiny",
                                  "coco_panoptic_r50_fpn", "retinanet_tiny",
                                  "coco_retinanet_r50", "fcos_tiny",
                                  "coco_fcos_r50", "detr_tiny",
                                  "coco_detr_r50", "voc_vgg16",
                                  "vitdet_tiny", "coco_vitdet_b"])
def test_slice_presets_equal_jax(name):
    from tpudet.cli.common import preset_config as jax_preset
    from tpudet_torch.cli.common import PRESETS, preset_config

    assert name in PRESETS
    port, ref = preset_config(name), jax_preset(name)
    assert port.model == ref.model
    for group in ("data", "backbone", "anchors", "rpn", "roi", "retinanet",
                  "fcos", "detr", "mask", "cascade", "keypoint", "panoptic",
                  "train"):
        assert_group_equals_jax(port, ref, group, f"{name}: ")


@pytest.mark.parametrize("name", ["tiny_cascade_config",
                                  "tiny_keypoint_config",
                                  "tiny_panoptic_config",
                                  "tiny_retinanet_config", "tiny_fcos_config",
                                  "tiny_detr_config", "tiny_vitdet_config"])
def test_family_tiny_configs_equal_jax_fields(name):
    port, ref = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert port.model == ref.model
    for group in ("data", "backbone", "anchors", "rpn", "roi", "retinanet",
                  "fcos", "detr", "mask", "cascade", "keypoint", "panoptic",
                  "train"):
        assert_group_equals_jax(port, ref, group, f"{name}: ")
        # Every field of the port's group but its own is a JAX field.
        assert ({f.name for f in dataclasses.fields(getattr(ref, group))}
                >= {f.name for f in dataclasses.fields(getattr(port, group))
                    if f"{group}.{f.name}" not in PORT_ONLY_FIELDS})
    for group in ("retinanet", "fcos", "detr", "cascade", "keypoint",
                  "panoptic"):
        assert ({f.name for f in dataclasses.fields(getattr(ref, group))}
                == {f.name for f in dataclasses.fields(getattr(port, group))})


def test_every_jax_preset_is_ported():
    """The port's ``PRESETS`` are the JAX package's 23 (the names its
    ``preset_config`` tests for), each equal to JAX's group by group."""
    import re

    from tpudet.cli.common import preset_config as jax_preset
    from tpudet_torch.cli.common import PRESETS, preset_config

    source = (ROOT / "tpudet" / "cli" / "common.py").read_text()
    names = set(re.findall(r'name == "([a-z0-9_]+)"', source))
    assert set(PRESETS) == names and len(PRESETS) == 23
    for name in PRESETS:
        port, ref = preset_config(name), jax_preset(name)
        for f in dataclasses.fields(port):
            if dataclasses.is_dataclass(getattr(port, f.name)):
                assert_group_equals_jax(port, ref, f.name, f"{name}: ")
