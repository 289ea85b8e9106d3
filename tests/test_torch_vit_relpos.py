"""ViTDet's decomposed relative positions (``BackboneConfig.vit_rel_pos``) in
the PyTorch port, on the CPU, held against the benchmark's plain reference
(``detbench/reference/vitdet.py``, detectron2's ``get_rel_pos`` and
``add_decomposed_rel_pos`` written out) on seeded random weights: the
attention of a window and of a global block on square grids and on an
8x10 grid (whose tables are resized), ``vit_tiny``'s ViTDet Faster R-CNN
predict, one training step's gradient into every table, the tables'
gradient summed over a tensor-parallel group, and no tables with the field
off (the JAX package has none: ``tests/test_vit.py`` and the
``test_torch_*`` files that build ``vit_tiny`` or ``coco_vitdet_b`` hold
that path to it).

Tolerances: f32 attention within 1e-5 of the output's largest magnitude;
bf16 attention within 2^-5 of it (the rule of
``tests/test_torch_bf16_parity.py``); f32 detections with the same
classes and validity, scores within 1e-5 and boxes within 1e-3 pixels; the
tensor-parallel tables' gradient within 1e-5 of the one-process one's
largest magnitude.
"""

import json
import os
import socket
from pathlib import Path

import pytest
import torch
import torch.multiprocessing as mp

from detbench import generator, weights as W
from detbench.reference import vitdet as R
from detbench.reference.common import Precision
from tpudet_torch.cli.common import preset_config
from tpudet_torch.config import apply_overrides
from tpudet_torch.data.preprocess import device_preprocess
from tpudet_torch.models import build_model
from tpudet_torch.models.vit import Attention

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
# The benchmark configuration at vit_tiny's width on 128x160 canvases.
TINY = {"backbone.name": "vit_tiny", "backbone.vit_window": 4,
        "backbone.vit_global_attn_every": 2, "backbone.vit_pos_grid": 8,
        "backbone.dtype": "float32", "rpn.conv_channels": 64,
        "roi.fc_dim": 64, "data.num_classes": 3,
        "data.aspect_buckets": [[128, 160]], "data.canvas_height": 128,
        "data.canvas_width": 160}


def bench_config(**sizes):
    cfg = json.loads((ROOT / "detbench" / "configs" / "coco_vitdet_b.json"
                      ).read_text())
    cfg["sizes"].update(TINY, **sizes)
    return cfg


def port_config(cfg):
    sizes = {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
             if isinstance(v, list) else v for k, v in cfg["sizes"].items()}
    return apply_overrides(preset_config(cfg["preset"]), sizes)


def drawn(cfg, seed=11):
    return W.draw(W.apply_draws(R.spec(cfg), cfg["draws"]), seed, "cpu")


def attention_pair(dtype, window, side, seed=3):
    """The port's Attention with tables of side ``side`` and the
    reference's, on one set of drawn weights."""
    cfg = bench_config(**{"backbone.dtype": str(dtype).split(".")[1]})
    z = R._sizes(cfg)
    dim, heads = z["dim"], z["heads"]
    attn = Attention(dim, heads, dtype, rel_pos=side, window=window)
    gen = torch.Generator().manual_seed(seed)
    p = {}
    for name, t in attn.named_parameters():
        draw = torch.randn(t.shape, generator=gen)
        draw *= 0.1 if "rel_pos" in name else t.shape[-1] ** -0.5
        p[f"blk.{name}"] = draw
    attn.load_state_dict({k[4:]: v for k, v in p.items()})
    return attn, p, z


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,grid,side", [
    ("window", (4, 4), 4),     # a window block: the table's own side
    ("global", (8, 8), 8),     # a global block on the table's grid
    ("global", (8, 10), 8),    # a global block whose tables are resized
])
def test_attention_with_rel_pos_equals_reference(dtype, kind, grid, side):
    attn, p, z = attention_pair(dtype, 4 if kind == "window" else 0, side)
    gen = torch.Generator().manual_seed(5)
    n = 3 if kind == "window" else 2
    x = torch.randn(n, grid[0] * grid[1], z["dim"], generator=gen).to(dtype)
    with torch.no_grad():
        got = attn(x, grid).float()
    want = R.attention(x, p, "blk", Precision(dtype), z, grid).float()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -5
    scale = want.abs().max()
    assert (got - want).abs().max() <= tol * scale
    # The terms matter: without them the output moves by a tenth of its
    # largest magnitude or more.
    attn.rel_pos = False
    with torch.no_grad():
        plain = attn(x, grid).float()
    assert (plain - want).abs().max() > 0.1 * scale


def test_vit_tiny_predict_with_rel_pos_equals_reference():
    cfg = bench_config()
    model = build_model(port_config(cfg), device="cpu")
    p = drawn(cfg)
    W.load_into(model.core, p)
    traffic = {"pool": 1, "batch": 2, "canvas": [128, 160],
               "valid_frac": [0.75, 1.0]}
    batch = generator.make_pool(traffic, 7, "cpu")[0]
    out = model.predict(device_preprocess(model.cfg, dict(batch)))
    ref = R.predict(p, batch["image"], batch["image_hw"], cfg,
                    Precision(torch.float32))
    assert ref["valid"].sum() > 0
    assert torch.equal(out["valid"], ref["valid"])
    v = ref["valid"]
    assert torch.equal(out["classes"][v].long(), ref["classes"][v].long())
    torch.testing.assert_close(out["scores"][v], ref["scores"][v],
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(out["boxes"][v], ref["boxes"][v], atol=1e-3,
                               rtol=0)


def test_training_step_reaches_every_table():
    cfg = port_config(bench_config(**{"data.canvas_width": 128,
                                      "data.aspect_buckets": [[128, 128]]}))
    model = build_model(cfg, device="cpu").init(0)
    tables = {n: t for n, t in model.core.named_parameters()
              if "rel_pos" in n}
    assert len(tables) == 4  # two blocks, h and w
    traffic = {"pool": 1, "batch": 2, "canvas": [128, 128],
               "valid_frac": [0.75, 1.0], "boxes_per_image": [1, 3]}
    batch = generator.make_pool(traffic, 9, "cpu", cfg.data.max_gt_boxes,
                                cfg.data.num_classes)[0]
    batch = device_preprocess(cfg, batch)
    loss, _ = model.loss(batch, torch.Generator().manual_seed(0))
    loss.backward()
    for name, t in tables.items():
        assert t.grad is not None and t.grad.abs().sum() > 0, name


def test_no_tables_with_the_field_off():
    for name in ("vitdet_tiny", "coco_vitdet_b"):
        cfg = preset_config(name)
        assert cfg.backbone.vit_rel_pos is False
        model = build_model(cfg, device="meta")
        assert not [n for n in model.core.state_dict() if "rel_pos" in n]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tp_worker(rank, port, out):
    """One rank of a tp=2 group: the global block's attention cut by the
    port's rules (a head a rank), its tables' gradient saved by rank 0."""
    import torch.distributed as dist

    from tpudet_torch.models.layers import shard_model
    from tpudet_torch.parallel.sharding_rules import tp_layout

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    core = torch.nn.Module()
    core.attn, _, z = attention_pair(torch.float32, 0, 8)
    shard_model(core, tp_layout(core), dist.group.WORLD)
    assert core.attn.local_heads == 1
    x = torch.randn(2, 80, z["dim"], generator=torch.Generator(
        ).manual_seed(5))
    core.attn(x, (8, 10)).square().sum().backward()
    if rank == 0:
        torch.save({n: core.attn.get_parameter(n).grad for n in
                    ("rel_pos_h", "rel_pos_w")}, out)
    dist.destroy_process_group()


def test_tensor_parallel_sums_the_tables_gradient(tmp_path):
    attn, _, z = attention_pair(torch.float32, 0, 8)
    x = torch.randn(2, 80, z["dim"], generator=torch.Generator(
        ).manual_seed(5))
    attn(x, (8, 10)).square().sum().backward()
    out = str(tmp_path / "grads.pt")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.spawn(_tp_worker, args=(_free_port(), out), nprocs=2)
    got = torch.load(out)
    for name in ("rel_pos_h", "rel_pos_w"):
        want = attn.get_parameter(name).grad
        assert (got[name] - want).abs().max() <= 1e-5 * want.abs().max()
