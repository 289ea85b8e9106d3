"""Traffic and weights come from the seed: the same seed gives the same
tensors, another seed other ones, and every seed the same sizes."""

import json
from pathlib import Path

import torch

from detbench import generator, weights as W
from detbench.reference import deformable_detr

HERE = Path(__file__).resolve().parents[1]
TRAFFIC = {"pool": 2, "batch": 2, "canvas": [64, 96],
           "valid_frac": [0.75, 1.0], "boxes_per_image": [1, 20]}
BIG = 2 ** 31 + 12345


def pools(seed):
    return generator.make_pool(TRAFFIC, seed, "cpu", max_gt_boxes=100,
                               num_classes=80)


def test_traffic_is_the_seeds():
    a, b, c = pools(BIG), pools(BIG), pools(BIG + 1)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a[0]["image"], c[0]["image"])
    assert not torch.equal(a[0]["gt_boxes"], c[0]["gt_boxes"])
    for x, z in zip(a, c):
        assert {k: v.shape for k, v in x.items()} == {
            k: v.shape for k, v in z.items()}
    hw = a[0]["image_hw"]
    assert bool(((hw >= torch.tensor([48, 72])) & (hw <= torch.tensor(
        [64, 96]))).all())
    # Padding is zero, boxes lie inside their image.
    h, w = int(hw[0, 0]), int(hw[0, 1])
    assert int(a[0]["image"][0, h:].sum()) == 0
    assert int(a[0]["image"][0, :, w:].sum()) == 0
    n = a[0]["gt_valid"].sum(1)
    assert bool(((n >= 1) & (n <= 20)).all())


def test_every_seed_plants_the_same_box_counts():
    def counts(seed):
        return [batch["gt_valid"].sum(1) for batch in pools(seed)]

    a, c = counts(BIG), counts(BIG + 1)
    assert sorted(torch.cat(a).tolist()) == sorted(torch.cat(c).tolist())
    assert sorted(torch.cat(a).tolist()) == [1, 6, 11, 16]


def test_weights_are_the_seeds():
    cfg = json.loads((HERE / "configs" /
                      "coco_deformable_detr_r50.json").read_text())
    spec = W.apply_draws(deformable_detr.spec(cfg), cfg["draws"])
    a, b, c = (W.draw(spec, s, "cpu") for s in (BIG, BIG, BIG + 1))
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    name = "enc0.deform_attn.sampling_offsets.weight"
    assert not torch.equal(a[name], c[name])
    assert abs(float(a[name].std()) - 0.08) < 0.005  # the file's draw
    # The official offset probe and the focal prior are the same for
    # every seed.
    assert torch.equal(a["enc0.deform_attn.sampling_offsets.bias"],
                       c["enc0.deform_attn.sampling_offsets.bias"])
    assert float(a["class_head0.bias"][0]) < -4.5
