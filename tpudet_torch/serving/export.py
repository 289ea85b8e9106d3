"""Ahead-of-time export and the serving artifact (``tpudet.serving.export``).

Deployment is ahead-of-time export: ``torch.export`` traces the whole
inference program (the device half of preprocessing, then ``predict``) at
a static batch size and canvas, with the weights inside the program. On
the card the kernels are ``tpudet::`` operators in the traced graph
(``tpudet_torch.kernels``), so the program launches the same Hopper kernels
as the live model; on the CPU it carries the plain versions. The artifact:

- is one zip (``ZIP_STORED``): a ``module_{h}x{w}.pt2`` (``torch.export.save``
  bytes) for each canvas and a ``metadata.json``;
- loads and runs in a process that never imports model code: this module's
  loader imports torch, numpy, ``tpudet_torch.config``, the host helpers of
  ``tpudet_torch.data.preprocess`` and the kernels' operator registrations;
- pins static shapes at export time (batch size, canvas): one program per
  shape, no retracing;
- runs on the device it was exported on (``platforms``: ``["cuda"]`` or
  ``["cpu"]``); ``kernels_embedded`` says whether its graph calls the
  ``tpudet::`` operators, read from the graph.

``ServingModel`` adds the host half around the programs: raw images ->
aspect-preserving resize onto the bucket's canvas -> run -> detections
rescaled back to original-image coordinates.
"""

from __future__ import annotations

import io
import json
import os
import warnings
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpudet_torch.config import DataConfig
from tpudet_torch.data.preprocess import (
    canvas_for_hw,
    device_preprocess,
    prepare_example,
    rescale_keypoints_to_original,
    rescale_to_original,
)
# The operators the exported graphs may call must be registered before a
# program is loaded.
from tpudet_torch.kernels import _ops
from tpudet_torch.kernels import deform_attn as _deform_attn  # noqa: F401
from tpudet_torch.kernels import frozen_bn as _frozen_bn  # noqa: F401
from tpudet_torch.kernels import nms as _nms  # noqa: F401
from tpudet_torch.kernels import roi_align as _roi_align  # noqa: F401
from tpudet_torch.kernels import roi_align_window as _roi_window  # noqa: F401

ARTIFACT_VERSION = 1
PLATFORMS = ("cuda", "cpu")


def _canvas_buckets(cfg) -> Tuple[Tuple[int, int], ...]:
    """Canvases the artifact exports: the aspect buckets when configured
    (one program per bucket, mirroring the training loader's batching), the
    two orientation canvases in orientation mode, else the single static
    canvas."""
    d = cfg.data
    if d.aspect_buckets:
        return tuple(tuple(b) for b in d.aspect_buckets)
    if d.orientation_buckets:
        return (
            (int(d.canvas_short), int(d.canvas_width)),
            (int(d.canvas_height), int(d.canvas_short)),
        )
    return ((int(d.canvas_height), int(d.canvas_width)),)


def _serving_metadata(cfg, batch_size: int, platforms: Sequence[str],
                      kernels_embedded: bool) -> Dict[str, Any]:
    d = cfg.data
    buckets = _canvas_buckets(cfg)
    # Postprocess knobs live in the family's config group.
    pp = {
        "retinanet": cfg.retinanet,
        "fcos": cfg.fcos,
        "detr": cfg.detr,
        "deformable_detr": cfg.deformable_detr,
    }.get(cfg.model) or cfg.roi
    return {
        "artifact_version": ARTIFACT_VERSION,
        "model": cfg.model,
        "batch_size": int(batch_size),
        "canvas_height": buckets[0][0],
        "canvas_width": buckets[0][1],
        "buckets": [list(b) for b in buckets],
        "min_size": int(d.min_size),
        "max_size": int(d.max_size),
        "num_classes": int(d.num_classes),
        "max_detections": int(pp.max_detections),
        "score_thresh": float(pp.score_thresh),
        "platforms": list(platforms),
        "backbone": cfg.backbone.name,
        "use_fpn": bool(cfg.backbone.use_fpn),
        # Whether the exported graphs call the Hopper kernels (the
        # ``tpudet::`` operators): a serving fleet audits artifacts for the
        # fast path. Read from the graphs, never assumed.
        "kernels_embedded": bool(kernels_embedded),
    }


def check_platforms(platforms: Optional[Sequence[str]]) -> Optional[str]:
    """``None`` or one of ``PLATFORMS`` -> the export device's type (None:
    the model's own). A program runs on the one device it was traced on."""
    if platforms is None or len(platforms) == 0:
        return None
    platforms = list(platforms)
    if len(platforms) != 1 or platforms[0] not in PLATFORMS:
        raise ValueError(
            f"platforms={platforms}: a tpudet_torch artifact runs on the one "
            f"device it was exported on, so name exactly one of {PLATFORMS} "
            "(a TPU or multi-platform artifact is the JAX package's "
            "tpudet.cli.export)")
    return platforms[0]


class _Serve(torch.nn.Module):
    """``(image uint8 [B, H, W, 3], image_hw f32 [B, 2])`` -> the model's
    detection dict: the program that is exported."""

    def __init__(self, cfg, model):
        super().__init__()
        self.cfg = cfg
        self.model = model

    def forward(self, image, image_hw):
        batch = device_preprocess(
            self.cfg, {"image": image, "image_hw": image_hw}, training=False)
        return self.model.predict(batch)


def export_model(cfg, model, batch_size: int,
                 platforms: Optional[Sequence[str]] = None,
                 canvas_hw: Optional[Tuple[int, int]] = None):
    """Trace the full inference step into a ``torch.export.ExportedProgram``.

    The program takes ``(image uint8 [B, H, W, 3], image_hw f32 [B, 2])``,
    the loader's output, and returns the model's detection dict (boxes,
    scores, classes, valid, num_detections in canvas coordinates, plus the
    family's masks or keypoints). The normalization is inside it and the
    model's weights are carried with it. ``platforms`` (``["cuda"]`` or
    ``["cpu"]``) must name the device the model lives on."""
    dev = model.device
    if check_platforms(platforms) not in (None, dev.type):
        raise ValueError(
            f"the model lives on {dev}, the export asks for {platforms}: "
            "build the model on the export device")
    ch, cw = canvas_hw or (cfg.data.canvas_height, cfg.data.canvas_width)
    example = (torch.zeros((batch_size, ch, cw, 3), dtype=torch.uint8,
                           device=dev),
               torch.full((batch_size, 2), float(min(ch, cw)),
                          dtype=torch.float32, device=dev))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), warnings.catch_warnings():
            # The models cache anchors by canvas; the export restores a
            # cache it fills while tracing (the program computes them).
            warnings.filterwarnings(
                "ignore", message=".*was assigned during export",
                category=UserWarning)
            return torch.export.export(_Serve(cfg, model), example,
                                       strict=False)
    finally:
        model.train(was_training)


def program_ops(program) -> List[str]:
    """The ``tpudet::`` operators an exported program calls."""
    return _ops.graph_ops(program.graph)


def _module_name(ch: int, cw: int) -> str:
    return f"module_{ch}x{cw}.pt2"


def save_artifact(path: str, cfg, model, batch_size: int,
                  platforms: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Export and write the serving artifact zip -> the metadata.

    With ``cfg.data.aspect_buckets`` the artifact carries one program per
    bucket canvas (the serving side of the loader's bucketed batching);
    otherwise one (two in orientation mode)."""
    device = check_platforms(platforms) or model.device.type
    embedded = False
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for ch, cw in _canvas_buckets(cfg):
            program = export_model(cfg, model, batch_size, [device],
                                   canvas_hw=(ch, cw))
            embedded |= bool(program_ops(program))
            buffer = io.BytesIO()
            torch.export.save(program, buffer)
            zf.writestr(_module_name(ch, cw), buffer.getvalue())
        meta = _serving_metadata(cfg, batch_size, [device], embedded)
        zf.writestr("metadata.json", json.dumps(meta, indent=2))
    return meta


def load_artifact(path: str):
    """Read an artifact zip -> ``({(ch, cw): ExportedProgram}, metadata)``."""
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("metadata.json"))
        if meta.get("artifact_version") != ARTIFACT_VERSION:
            raise ValueError(
                f"artifact version {meta.get('artifact_version')} != "
                f"{ARTIFACT_VERSION}")
        modules = {}
        for ch, cw in [tuple(b) for b in meta["buckets"]]:
            modules[(ch, cw)] = torch.export.load(
                io.BytesIO(zf.read(_module_name(ch, cw))))
    return modules, meta


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class ServingModel:
    """Host-side wrapper around loaded (or freshly exported) programs.

    ``detect(images)`` is the deployment call: route each raw image to the
    best-fitting canvas bucket, resize and pad it onto that canvas (on a
    thread pool), batch per bucket (short batches padded to the exported
    batch size), run the bucket's program, keep the valid detections over
    the score threshold and rescale them to original-image coordinates.
    Results come back in input order."""

    def __init__(self, modules: Dict[Tuple[int, int], Any],
                 meta: Dict[str, Any]):
        self.meta = meta
        self.device = torch.device(meta["platforms"][0])
        self.programs = dict(modules)
        self._calls = {hw: p.module() for hw, p in modules.items()}
        self._pool = ThreadPoolExecutor(min(8, os.cpu_count() or 1))
        # A DataConfig of the exported preprocessing contract.
        buckets = tuple(tuple(b) for b in meta["buckets"])
        self._data_cfg = DataConfig(
            min_size=meta["min_size"],
            max_size=meta["max_size"],
            canvas_height=meta["canvas_height"],
            canvas_width=meta["canvas_width"],
            aspect_buckets=buckets if len(buckets) > 1 else (),
            max_gt_boxes=1,
            num_classes=meta["num_classes"],
        )

    @classmethod
    def load(cls, path: str) -> "ServingModel":
        modules, meta = load_artifact(path)
        return cls(modules, meta)

    @property
    def batch_size(self) -> int:
        return self.meta["batch_size"]

    def __call__(self, image, image_hw) -> Dict[str, torch.Tensor]:
        """Run a program on an already-prepared canvas batch (arrays or
        tensors; the batch's ``[H, W]`` selects the bucket) -> the detection
        dict on the program's device."""
        image = torch.as_tensor(image).to(self.device, non_blocking=True)
        image_hw = torch.as_tensor(image_hw, dtype=torch.float32).to(
            self.device, non_blocking=True)
        with torch.inference_mode():
            return self._calls[tuple(image.shape[1:3])](image, image_hw)

    def detect(self, images: List[np.ndarray],
               score_thresh: Optional[float] = None
               ) -> List[Dict[str, np.ndarray]]:
        """Raw uint8 ``[h, w, 3]`` images -> per-image detections in
        original coordinates: ``{"boxes" [n, 4], "scores" [n], "classes"
        [n]}``, with ``"masks"`` (box-frame probabilities, unchanged) and
        ``"keypoints"`` (rescaled) where the program returns them."""
        if score_thresh is None:
            score_thresh = self.meta["score_thresh"]
        bs = self.batch_size
        by_bucket: Dict[Tuple[int, int], List[int]] = {}
        for i, img in enumerate(images):
            hw = canvas_for_hw(self._data_cfg, *img.shape[:2])
            by_bucket.setdefault(tuple(hw), []).append(i)

        no_boxes = (np.zeros((0, 4), np.float32), np.zeros(0, np.int32))

        def prep(i):
            return prepare_example(self._data_cfg, images[i], *no_boxes)

        results: List[Optional[Dict[str, np.ndarray]]] = [None] * len(images)
        for bucket, idxs in by_bucket.items():
            for start in range(0, len(idxs), bs):
                chunk = idxs[start:start + bs]
                prepared = list(self._pool.map(prep, chunk))
                pad = bs - len(prepared)
                canvases = np.stack(
                    [p["image"] for p in prepared]
                    + [np.zeros_like(prepared[0]["image"])] * pad)
                hw = np.stack(
                    [p["image_hw"] for p in prepared]
                    + [prepared[0]["image_hw"]] * pad).astype(np.float32)
                out = {k: _numpy(v) for k, v in
                       self(torch.from_numpy(canvases),
                            torch.from_numpy(hw)).items()}
                for k, (i, p) in enumerate(zip(chunk, prepared)):
                    keep = out["valid"][k] & (out["scores"][k] >= score_thresh)
                    results[i] = {
                        "boxes": rescale_to_original(
                            out["boxes"][k][keep].astype(np.float32),
                            p["image_scale"], p["orig_hw"]),
                        "scores": out["scores"][k][keep],
                        "classes": out["classes"][k][keep],
                    }
                    if "masks" in out:
                        # Box-frame mask probabilities ride through: the
                        # rescale is carried by the boxes (paste with
                        # data/masks.py::paste_mask).
                        results[i]["masks"] = out["masks"][k][keep]
                    if "keypoints" in out:
                        results[i]["keypoints"] = (
                            rescale_keypoints_to_original(
                                out["keypoints"][k][keep].astype(np.float32),
                                p["image_scale"], p["orig_hw"]))
        return results  # type: ignore[return-value]
