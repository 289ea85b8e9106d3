"""ViTDet (the ViT and the simple feature pyramid) through the serving
artifact on the CPU, with the static plain multi-level pooler: exported at
b=1, written, loaded and run, equal to the live model's predict exactly
(``tests/test_torch_serving_families.py``'s roundtrip; each FPN family has
a file of its own because its exported graph, with the FPN proposals' NMS
over 512 candidates unrolled, takes tens of seconds on a CPU to write and
read)."""

from tests.test_torch_serving_families import roundtrip
from tpudet_torch import config as tconfig


def test_serving_export_roundtrip_vitdet(tmp_path):
    keys = roundtrip(tconfig.tiny_vitdet_config, tmp_path)
    assert keys == sorted(["boxes", "classes", "num_detections", "scores",
                           "valid"])
