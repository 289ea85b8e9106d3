"""RetinaNet of the PyTorch port against ``tpudet``'s, on the CPU, at
``retinanet_tiny``: the anchors and their level sizes, the constructor's
refusals, ``RetinaNetFPN`` and the shared head on every level, the
targets (``_targets_single``), ``loss`` and its gradients, ``predict`` with
the prefilter on and off (and the eval CLI's referee pinning it off), the
tiny learning check at tpudet's bar (``tests/test_retinanet.py``: SGD 0.02,
no warmup, 15 steps, the last loss under 0.8x the first) and the CLIs.

Weights: Flax's init, then the output convs drawn wider (``widened``): at
Flax's normal(0.01) and the prior bias every score sits near 0.01, under
``score_thresh`` 0.05, and predict would keep nothing.

Tolerances (f32): anchors, level sizes, matched indices, labels and target
classes exactly equal, target deltas within 1e-5; the pyramid and the head
per level within 1e-5 of the level's largest magnitude (relative); each
loss term within 1e-5 relative; each gradient within 1e-4 of its largest
magnitude plus 1e-5 of its own values plus 1e-6 of the model's largest
gradient (as ``tests/test_torch_cascade.py``); detections: the same valid
masks and classes, boxes within 1e-3 px plus 1e-4 relative, scores within
1e-5 (two detections whose scores tie within that may trade places).

The training batch is ``train_batch``'s seed 5. At its seed 4 one unit of
the box tower's second conv at p4 sits at 1.2e-7 of the layer's largest
magnitude, within f32 rounding of the ReLU's kink: the two packages take
its two sides and the box tower's, the pyramid's and the backbone's
gradients part by 1-3% (the gradient of the loss in the deltas is equal
bit for bit, and each package is right to f32).
"""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deformable_detr_train import train_batch
from tpudet import config as jconfig
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models import RetinaNet as JaxRetinaNet
from tpudet.models.retinanet import RetinaNetCore as JaxCore
from tpudet.ops import anchors as jax_anchors
from tpudet_torch import config as tconfig
from tpudet_torch.cli import detect as tdetect
from tpudet_torch.cli import eval as teval
from tpudet_torch.cli import train as ttrain
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.models.retinanet import RetinaNet
from tpudet_torch.ops import anchors as tanchors
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)
BOX_ATOL, BOX_RTOL, SCORE_ATOL = 1e-3, 1e-4, 1e-5
LEVELS = ("p3", "p4", "p5", "p6", "p7")
METRICS = {"loss", "focal_cls_loss", "box_loss", "num_pos_anchors"}
# The output convs' kernels: wide enough that a few percent of the
# (anchor, class) pairs pass score_thresh and the boxes move off their
# anchors.
WIDE = {"cls_logits": 0.05, "box_deltas": 0.02, "box_dists": 0.02,
        "centerness": 0.05}


def t(x):
    return torch.from_numpy(np.array(x))


def widened(variables, seed, std=WIDE):
    """Flax's init with the head's output kernels drawn from N(0, std)."""
    rng = np.random.default_rng(seed)
    v = flax.core.unfreeze(jax.tree_util.tree_map(np.asarray, variables))
    for name, s in std.items():
        p = v["params"]["head"].get(name)
        if p is not None:
            p["kernel"] = rng.normal(0, s, p["kernel"].shape).astype(
                np.float32)
    return v


def configs(**fields):
    """retinanet_tiny in both packages, ``fields`` replacing entries of its
    ``retinanet`` group."""
    return [c.replace(retinanet=dataclasses.replace(c.retinanet, **fields))
            for c in (jconfig.tiny_retinanet_config(),
                      tconfig.tiny_retinanet_config())]


def pair(jm, jcfg, tcfg, seed):
    v = widened(jax.jit(jm.init)(jax.random.key(seed)), seed)
    tm = build_model(tcfg, device="cpu")
    tm.core.load_state_dict(from_flax_variables(v))  # strict
    return v, tm


def uint8_batch(seed, b=2, h=128, w=128):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
            "image_hw": np.array([[h, w], [h * 0.75, w * 0.875]],
                                 np.float32)[:b]}


def assert_same_detections(port, ref):
    """Same valid masks and counts; each detection has a counterpart of the
    same class, score and box (tolerances above) in place, or in the place
    of one whose score ties with it."""
    np.testing.assert_array_equal(port["valid"], ref["valid"])
    np.testing.assert_array_equal(port["num_detections"],
                                  ref["num_detections"])
    for b in range(ref["valid"].shape[0]):
        n = int(ref["num_detections"][b])
        free = list(range(n))
        for i in range(n):
            match = [k for k in free
                     if port["classes"][b, k] == ref["classes"][b, i]
                     and abs(port["scores"][b, k] - ref["scores"][b, i])
                     < SCORE_ATOL
                     and np.allclose(port["boxes"][b, k], ref["boxes"][b, i],
                                     rtol=BOX_RTOL, atol=BOX_ATOL)]
            assert match, f"detection {i} of image {b} has no counterpart"
            k = min(match, key=lambda m: abs(m - i))
            assert k == i or abs(ref["scores"][b, k] - ref["scores"][b, i]) \
                < SCORE_ATOL
            free.remove(k)
        assert (port["scores"][b, n:] == 0).all()
        assert (port["classes"][b, n:] == 0).all()


def predict_both(jm, v, jcfg, tm, tcfg, batch):
    ref = jax.jit(lambda v, bt: jm.predict(v, jax_preprocess(jcfg, bt)))(
        v, batch)
    ref = {k: np.asarray(x) for k, x in ref.items()}
    out = {k: x.numpy() for k, x in make_eval_step(tm, tcfg)(batch).items()}
    assert set(out) == set(ref)
    return out, ref


def assert_levels_close(port, ref, label):
    """f32 within 1e-5 of the level's largest magnitude."""
    scale = np.abs(ref).max()
    assert scale > 0, label
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=label)


def assert_grads_equal(tm, ref_grads):
    assert set(n for n, _ in tm.core.named_parameters()) == set(ref_grads)
    floor = 1e-6 * max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in tm.core.named_parameters():
        want = ref_grads[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-4 * np.abs(want).max() + floor,
                                   err_msg=name)


def synthetic_batch(cfg, seed=0, b=2):
    """The port's synthetic dataset through its loader and
    ``device_preprocess``: the JAX tests' ``make_batch``."""
    from tpudet_torch.data import DataLoader, SyntheticDataset
    from tpudet_torch.data.preprocess import device_preprocess

    ds = SyntheticDataset(num_classes=cfg.data.num_classes, num_examples=b,
                          image_size=cfg.data.canvas_height, seed=seed)
    raw = next(iter(DataLoader(cfg, ds, b, shuffle=False,
                               num_workers=1).batches(0)))
    return device_preprocess(cfg, {k: torch.from_numpy(x)
                                   for k, x in raw.items()})


def learning_losses(cfg, steps):
    """``steps`` train steps of ``cfg`` on one synthetic batch of 2 on the
    CPU -> each step's loss."""
    from tpudet_torch.train.state import create_train_state
    from tpudet_torch.train.step import make_train_step

    model = build_model(cfg, device="cpu")
    state = create_train_state(model, cfg.train, seed=0, device="cpu")
    step = make_train_step(model, cfg, device="cpu")
    batch = synthetic_batch(cfg)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def cli_train_eval_detect(tmp_path, capsys, preset, loss, overrides=()):
    """``cli.train`` 2 steps, ``cli.eval`` of 4 images and ``cli.detect`` of
    one PNG on the CPU -> (the eval summary, the detected boxes)."""
    from PIL import Image

    argv = ["--preset", preset, "--dataset", "synthetic", "--device", "cpu"]
    for item in overrides:
        argv += ["--set", item]
    ckpt = tmp_path / "ckpt"
    state = ttrain.main(argv + ["--steps", "2", "--batch-size", "2",
                                "--checkpoint-dir", str(ckpt),
                                "--set", "train.log_every=1"])
    out = capsys.readouterr().out
    assert state.step == 2 and loss in out and "[train step 2]" in out
    summary = teval.main(argv + ["--checkpoint-dir", str(ckpt),
                                 "--max-images", "4", "--batch-size", "2"])
    assert "mAP: " in capsys.readouterr().out
    image = tmp_path / "x.png"
    Image.fromarray(np.full((96, 128, 3), 90, np.uint8)).save(image)
    boxes, _, _ = tdetect.main(argv + [
        "--checkpoint-dir", str(ckpt), "--image", str(image), "--output",
        str(tmp_path / "o.png"), "--score-thresh", "0.0"])
    assert (tmp_path / "o.png").exists()
    return summary, boxes


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("canvas", [(128, 128), (96, 160), (832, 1344)])
def test_anchors_and_level_sizes_equal_jax(canvas):
    """The per-canvas anchors of both the tiny and the COCO preset, with the
    ceil-grid rule, exactly equal; and ``generate_fpn_anchors``."""
    from tpudet.cli.common import preset_config as jax_preset
    from tpudet_torch.cli.common import preset_config

    for name in ("retinanet_tiny", "coco_retinanet_r50"):
        jm = JaxRetinaNet(jax_preset(name))
        tm = build_model(preset_config(name), device="cpu")
        np.testing.assert_array_equal(tm.anchor_boxes(canvas).numpy(),
                                      np.asarray(jm.anchor_boxes(canvas)))
        assert tm.anchor_level_sizes(canvas) == jm.anchor_level_sizes(canvas)
    shapes = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in (8, 16, 32)]
    ref, ref_counts = jax_anchors.generate_fpn_anchors(
        shapes, (8, 16, 32), (32.0, 64.0, 128.0), (0.5, 1.0, 2.0))
    out, counts = tanchors.generate_fpn_anchors(
        shapes, (8, 16, 32), (32.0, 64.0, 128.0), (0.5, 1.0, 2.0))
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert counts == ref_counts


def test_coco_level_sizes_at_832():
    """129,726 anchors per 832x832 image: 104^2 + 52^2 + 26^2 + 13^2 + 7^2
    cells, 9 anchors each."""
    from tpudet_torch.cli.common import preset_config

    tm = build_model(preset_config("coco_retinanet_r50"), device="cpu")
    assert sum(tm.anchor_level_sizes((832, 832))) == 129726


@pytest.mark.parametrize("case,match", [
    ("rpn_only", "rpn_only"), ("no_fpn", "use_fpn"),
    ("strides", "fixed P3-P7")])
def test_constructor_refusals_as_jax(case, match):
    cfgs = []
    for cfg in (jconfig.tiny_retinanet_config(),
                tconfig.tiny_retinanet_config()):
        cfgs.append({
            "rpn_only": lambda: cfg.replace(rpn_only=True),
            "no_fpn": lambda: cfg.replace(backbone=dataclasses.replace(
                cfg.backbone, use_fpn=False)),
            "strides": lambda: cfg.replace(anchors=dataclasses.replace(
                cfg.anchors, fpn_strides=(4, 8, 16, 32, 64))),
        }[case]())
    with pytest.raises(ValueError, match=match) as ref:
        JaxRetinaNet(cfgs[0])
    with pytest.raises(ValueError, match=match) as port:
        build_model(cfgs[1], device="cpu")
    assert str(port.value) == str(ref.value)


def test_build_model_on_cuda_by_default():
    """The entry point's default device is the card; building the model
    needs none (its layers take the device as they are made) but the first
    call does."""
    import inspect

    from tpudet_torch.models import build_model as factory

    assert inspect.signature(factory).parameters["device"].default == "cuda"
    assert inspect.signature(RetinaNet).parameters["device"].default == "cuda"


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def run():
    """tpudet's features, heads, targets, loss and gradients on one batch,
    and the port's model with the same weights."""
    jcfg, tcfg = configs()
    jm = JaxRetinaNet(jcfg)
    v, tm = pair(jm, jcfg, tcfg, seed=3)
    batch = train_batch(tcfg, seed=5)
    images = jnp.asarray(batch["image"])

    def forward(v, images):
        feats = jm.core.apply(v, images, method=JaxCore.features)
        return feats, jm.core.apply(v, feats, method=JaxCore.heads)

    feats, heads = jax.jit(forward)(v, images)
    anchors = jm.anchor_boxes(images.shape[1:3])
    targets = jax.jit(jax.vmap(functools.partial(
        jm._targets_single, anchors)))(batch["gt_boxes"],
                                       batch["gt_classes"], batch["gt_valid"])

    def loss(params):
        return jm.loss({**v, "params": params}, batch, jax.random.key(0))

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    return dict(
        jm=jm, v=v, tm=tm, jcfg=jcfg, tcfg=tcfg, batch=batch,
        feats={k: np.asarray(x) for k, x in feats.items()},
        heads=[np.asarray(x) for x in heads],
        targets=[np.asarray(x) for x in targets],
        metrics={k: float(x) for k, x in metrics.items()},
        grads=from_flax_variables({"params": grads}))


def test_pyramid_equals_jax_per_level(run):
    tm = run["tm"]
    with torch.no_grad():
        feats = tm.core.features(t(run["batch"]["image"]))
    assert sorted(feats) == sorted(run["feats"]) == list(LEVELS)
    for name in LEVELS:
        out = feats[name].permute(0, 2, 3, 1).numpy()
        assert out.shape == run["feats"][name].shape
        assert_levels_close(out, run["feats"][name], name)


def test_head_equals_jax_per_level(run):
    """The shared head on tpudet's own pyramid, level by level, in the
    (y, x, a) order of the anchors."""
    tm = run["tm"]
    sizes = tm.anchor_level_sizes((128, 128))
    with torch.no_grad():
        feats = {k: t(x).permute(0, 3, 1, 2) for k, x in run["feats"].items()}
        logits, deltas = tm.core.heads(feats)
    start = 0
    for name, n in zip(LEVELS, sizes):
        for port, ref, what in ((logits, run["heads"][0], "logits"),
                                (deltas, run["heads"][1], "deltas")):
            assert_levels_close(port[:, start:start + n].numpy(),
                                ref[:, start:start + n], f"{name} {what}")
        start += n
    assert start == logits.shape[1]


def test_targets_equal_jax(run):
    tm, batch = run["tm"], run["batch"]
    cls, deltas, labels = run["targets"]
    out = tm._targets_single(tm.anchor_boxes((128, 128)), t(batch["gt_boxes"]),
                             t(batch["gt_classes"]), t(batch["gt_valid"]))
    np.testing.assert_array_equal(out[2].numpy(), labels)
    np.testing.assert_array_equal(out[0].numpy(), cls)
    fg = labels == 1
    assert 5 < fg.sum() and (labels == -1).any()
    np.testing.assert_allclose(out[1].numpy()[fg], deltas[fg], rtol=1e-5,
                               atol=1e-5)


def test_loss_terms_and_gradients_equal_jax(run):
    tm, ref = run["tm"], run["metrics"]
    total, metrics = tm.loss({k: t(x) for k, x in run["batch"].items()})
    assert set(metrics) == set(ref) == METRICS
    for k in ref:
        assert float(metrics[k].detach()) == pytest.approx(ref[k], rel=1e-5), k
    assert ref["num_pos_anchors"] > 3 and ref["box_loss"] > 0
    total.backward()
    assert_grads_equal(tm, run["grads"])


@pytest.mark.parametrize("prefilter", ["off", "on"])
def test_predict_equals_jax(prefilter):
    """make_eval_step (uint8 canvases, fused preprocess) against tpudet's
    predict: the flattened selection and the prefilter (on levels p3..p5
    of the tiny canvas, where a level has more anchors than k)."""
    jcfg, tcfg = configs(prefilter=prefilter)
    jm = JaxRetinaNet(jcfg)
    v, tm = pair(jm, jcfg, tcfg, seed=5)
    out, ref = predict_both(jm, v, jcfg, tm, tcfg, uint8_batch(6))
    assert (ref["num_detections"] > 5).all()
    assert_same_detections(out, ref)


def test_referee_config_pins_the_prefilter_off():
    from tpudet.cli.eval import referee_config as jax_referee
    from tpudet_torch.cli.eval import referee_config

    for value, want in (("auto", "off"), ("on", "on"), ("off", "off")):
        jcfg, tcfg = configs(prefilter=value)
        assert referee_config(tcfg).retinanet.prefilter == want
        assert jax_referee(jcfg).retinanet.prefilter == want


# --------------------------------------------------------------- learning
def test_tiny_learning_check():
    """tpudet's bar (tests/test_retinanet.py): SGD 0.02, no warmup, 15 steps
    on one synthetic batch; the first loss under 10 (the prior keeps the
    focal sum O(1)), the last under 0.8x the first."""
    cfg = tconfig.tiny_retinanet_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, learning_rate=0.02, warmup_steps=0))
    losses = learning_losses(cfg, 15)
    first, last = losses[0], losses[-1]
    assert np.isfinite(losses).all() and first < 10.0
    assert last < 0.8 * first, (first, last)


def test_cli_train_eval_detect(tmp_path, capsys):
    _, boxes = cli_train_eval_detect(
        tmp_path, capsys, "retinanet_tiny", "focal_cls_loss=",
        ["retinanet.score_thresh=0.0"])
    assert len(boxes) > 0
