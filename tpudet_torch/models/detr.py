"""DETR inference and training (``tpudet.models.detr``; Carion et al.,
arXiv:2005.12872), and the parts Deformable DETR reuses: the 2-D sine
positional embedding, the FFN, and multi-head attention in Flax's parameter
layout with Flax's key mask, each with Flax's dropout sites (active only
when a ``torch.Generator`` is passed: see ``layers.dropout``).

``DETRCore``: the backbone's C5, a 1x1 projection to ``d_model`` tokens, a
post-norm encoder (the sine embedding of each image's valid extent added to
Q and K, canvas padding masked as a key), a post-norm decoder over learned
queries (``dec_norm`` after every layer), a class head over C + 1 columns
(0 is no-object) and a 3-layer box MLP to sigmoid (cx, cy, w, h) relative
to each image's true extent. ``DETR``: the set loss per decoder layer and
image (``train.losses.detr_set_loss``, the Hungarian matcher on the host)
and the postprocess, a top-k over (query, class) posteriors. No anchors, no
NMS, no RoI pooling: this path launches none of the port's kernels.

Dtypes follow the JAX package's flow: the projections, attention, FFN and
heads compute in the model dtype; Flax's LayerNorm returns f32, so in the
bf16 preset the residual stream is f32 after the first norm. Module names
follow the Flax tree (``input_proj``, ``enc0.self_attn.query``,
``dec0.cross_attn``, ``dec_norm``, ``class_head``, ``bbox_fc0``,
``bbox_out``, ``query_embed``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.config import Config
from tpudet_torch.models.layers import (
    Conv,
    Dense,
    LayerNorm,
    dropout,
    init_module,
    normal_,
)
from tpudet_torch.models.resnet import build_backbone
from tpudet_torch.ops import boxes as box_ops
from tpudet_torch.ops import selection
from tpudet_torch.train import losses


def sine_position_embedding(valid: torch.Tensor, d_model: int,
                            temperature: float = 10000.0) -> torch.Tensor:
    """``[..., H, W]`` validity mask -> ``[..., H, W, d_model]`` f32 2-D sine
    embedding: row and column positions are cumulative valid counts scaled
    to [0, 2π] over the image's true extent (canvas-padding-invariant); half
    the channels encode y, half x, alternating sin/cos over a geometric
    frequency ladder. The JAX function takes one image; this one any
    leading axes."""
    m = valid.to(torch.float32)
    eps = 1e-6
    scale = 2.0 * math.pi
    y = torch.cumsum(m, dim=-2)
    x = torch.cumsum(m, dim=-1)
    y = y / (y[..., -1:, :] + eps) * scale
    x = x / (x[..., :, -1:] + eps) * scale
    half = d_model // 2
    steps = torch.div(torch.arange(half, dtype=torch.float32, device=m.device),
                      2, rounding_mode="floor")
    dim_t = temperature ** (2.0 * steps / torch.tensor(float(half),
                                                       device=m.device))
    py = y[..., None] / dim_t
    px = x[..., None] / dim_t
    shape = valid.shape + (half,)
    py = torch.stack([torch.sin(py[..., 0::2]), torch.cos(py[..., 1::2])],
                     dim=-1).reshape(shape)
    px = torch.stack([torch.sin(px[..., 0::2]), torch.cos(px[..., 1::2])],
                     dim=-1).reshape(shape)
    return torch.cat([py, px], dim=-1)


class _FFN(nn.Module):
    """``fc1`` -> ReLU -> dropout -> ``fc2``, computing in ``dtype``. Under
    tensor parallelism ``fc1`` is column- and ``fc2`` row-parallel, and the
    dropout between them draws the full-width mask and keeps this rank's
    columns (``layers.dropout``)."""

    def __init__(self, d_model: int, ffn_dim: int, dtype: torch.dtype,
                 device=None, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.fc1 = Dense(d_model, ffn_dim, dtype=dtype, device=device)
        self.fc2 = Dense(ffn_dim, d_model, dtype=dtype, device=device)
        self.tp = None

    def shard_tp(self, tp) -> None:
        if self.fc1.tp is not None:
            self.tp = tp

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.relu(self.fc1(x)), self.dropout, generator, self.tp)
        return self.fc2(h)


class MultiHeadDotProductAttention(nn.Module):
    """Flax's ``nn.MultiHeadDotProductAttention``:
    ``query``/``key``/``value`` projections to ``heads x head_dim``, the
    query scaled by ``1/sqrt(head_dim)`` (rounded to ``dtype``) before
    ``q·kᵀ``, masked keys' logits set to ``finfo(dtype).min`` (Flax's
    ``mask``, ``[B, 1, 1, K]`` bool, True where a key may be attended), a
    softmax over keys, dropout on the probabilities (Flax's
    ``broadcast_dropout``: one ``[q, k]`` mask for every image and head,
    the multiplier ``keep / keep_prob`` in ``dtype``), and the ``out``
    projection, all in ``dtype``. Flax keeps the projections as ``DenseGeneral`` kernels
    ``[d, heads, hd]`` (``out``: ``[heads, hd, d]``); here each is a Linear
    over the flattened ``heads * hd`` axis (``models.import_weights`` maps
    them). Under tensor parallelism (``layers.shard_model``) the
    projections to heads are column- and ``out`` row-parallel, and a rank
    computes ``num_heads / size`` heads; the probabilities' dropout mask has
    no head axis, so the model peers, whose generators are in one state,
    draw the one-process mask."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 device=None, dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.local_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        # sqrt(head_dim) in f32 (a double rounded to f32 is the correctly
        # rounded f32 square root), filled on the device in ``dtype`` at
        # each call: a true division by it, with no host-to-device copy.
        self.root = float(np.float32(math.sqrt(d_model // num_heads)))
        self.query = Dense(d_model, d_model, dtype=dtype, device=device)
        self.key = Dense(d_model, d_model, dtype=dtype, device=device)
        self.value = Dense(d_model, d_model, dtype=dtype, device=device)
        self.out = Dense(d_model, d_model, dtype=dtype, device=device)

    def shard_tp(self, tp) -> None:
        if self.value.tp is not None:
            if self.num_heads % tp.size:
                raise ValueError(f"{self.num_heads} heads over a model axis "
                                 f"of {tp.size}")
            self.local_heads = self.num_heads // tp.size

    def forward(self, inputs_q: torch.Tensor, inputs_k: torch.Tensor,
                inputs_v: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, nq, _ = inputs_q.shape
        nk = inputs_k.shape[1]
        h, hd = self.local_heads, self.head_dim
        q = self.query(inputs_q).reshape(b, nq, h, hd)
        k = self.key(inputs_k).reshape(b, nk, h, hd)
        v = self.value(inputs_v).reshape(b, nk, h, hd)
        root = torch.full((), self.root, dtype=q.dtype, device=q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", q / root, k)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1)
        rate = self.dropout_rate
        if generator is not None and rate > 0.0:
            keep_prob = 1.0 - rate
            keep = torch.rand((1, 1) + attn.shape[-2:], generator=generator,
                              device=attn.device) < keep_prob
            attn = attn * (keep.to(attn.dtype) / torch.full(
                (), keep_prob, dtype=attn.dtype, device=attn.device))
        x = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out(x.reshape(b, nq, h * hd))


class EncoderLayer(nn.Module):
    """Post-norm encoder layer: self-attention with the positional
    embedding on Q and K only (appendix A.3) and padded tokens masked as
    keys, then the FFN; dropout on both branches and inside them when a
    generator is passed."""

    def __init__(self, d_model, num_heads, ffn_dim, dtype, device=None,
                 dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadDotProductAttention(d_model, num_heads,
                                                      dtype, device, dropout)
        self.norm1 = LayerNorm(d_model, device=device)
        self.ffn = _FFN(d_model, ffn_dim, dtype, device, dropout)
        self.norm2 = LayerNorm(d_model, device=device)

    def forward(self, src, pos, key_mask, generator=None):
        q = src + pos
        attn = self.self_attn(q, q, src, generator, key_mask)
        src = self.norm1(src + dropout(attn, self.dropout, generator))
        ffn = self.ffn(src, generator)
        return self.norm2(src + dropout(ffn, self.dropout, generator))


class DecoderLayer(nn.Module):
    """Post-norm decoder layer: query self-attention (the query embedding on
    Q and K), cross-attention into the encoder memory (the query embedding
    on Q, the spatial embedding on K, padded tokens masked), the FFN."""

    def __init__(self, d_model, num_heads, ffn_dim, dtype, device=None,
                 dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadDotProductAttention(d_model, num_heads,
                                                      dtype, device, dropout)
        self.norm1 = LayerNorm(d_model, device=device)
        self.cross_attn = MultiHeadDotProductAttention(d_model, num_heads,
                                                       dtype, device, dropout)
        self.norm2 = LayerNorm(d_model, device=device)
        self.ffn = _FFN(d_model, ffn_dim, dtype, device, dropout)
        self.norm3 = LayerNorm(d_model, device=device)

    def forward(self, tgt, query_pos, memory, pos, key_mask, generator=None):
        rate = self.dropout
        q = tgt + query_pos
        attn = self.self_attn(q, q, tgt, generator)
        tgt = self.norm1(tgt + dropout(attn, rate, generator))
        attn = self.cross_attn(tgt + query_pos, memory + pos, memory,
                               generator, key_mask)
        tgt = self.norm2(tgt + dropout(attn, rate, generator))
        ffn = self.ffn(tgt, generator)
        return self.norm3(tgt + dropout(ffn, rate, generator))


class DETRCore(nn.Module):
    """Backbone C5 -> 1x1 projection -> encoder -> decoder -> shared heads."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        bb = cfg.backbone
        d = cfg.detr
        dtype = torch.bfloat16 if bb.dtype == "bfloat16" else torch.float32
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = build_backbone(bb.name, bb.norm, dtype,
                                       bb.stride_in_1x1, device,
                                       freeze_stem=bb.freeze_stem,
                                       s2d_stem=bb.s2d_stem, remat=bb.remat)
        self.input_proj = Conv(self.backbone.channels["c5"], d.d_model, 1,
                               dtype=dtype, device=device)
        self.query_embed = nn.Parameter(
            torch.zeros(d.num_queries, d.d_model, device=device))
        layer = dict(d_model=d.d_model, num_heads=d.num_heads,
                     ffn_dim=d.ffn_dim, dtype=dtype, device=device,
                     dropout=d.dropout)
        for i in range(d.enc_layers):
            self.add_module(f"enc{i}", EncoderLayer(**layer))
        for i in range(d.dec_layers):
            self.add_module(f"dec{i}", DecoderLayer(**layer))
        self.dec_norm = LayerNorm(d.d_model, device=device)
        self.class_head = Dense(d.d_model, cfg.data.num_classes + 1,
                                dtype=dtype, device=device)
        self.bbox_fc0 = Dense(d.d_model, d.d_model, dtype=dtype, device=device)
        self.bbox_fc1 = Dense(d.d_model, d.d_model, dtype=dtype, device=device)
        self.bbox_out = Dense(d.d_model, 4, dtype=dtype, device=device)

    def forward(self, images: torch.Tensor, image_hw: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, H, W, 3]`` images, ``[B, 2]`` f32 (h, w) -> per decoder
        layer ``[L, B, Q, C + 1]`` f32 logits and ``[L, B, Q, 4]`` sigmoid
        (cx, cy, w, h) boxes. ``generator`` (None: no dropout) draws every
        dropout mask."""
        d = self.cfg.detr
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        src = self.input_proj(self.backbone(x, stop_at="c5")["c5"])
        b, _, hf, wf = src.shape
        stride_y = -(-images.shape[1] // hf)  # ceil (SAME-padded convs)
        stride_x = -(-images.shape[2] // wf)
        # A token is valid where its receptive field's origin lies inside
        # the image's true extent.
        dev = images.device
        ys = torch.arange(hf, dtype=torch.float32, device=dev) * stride_y
        xs = torch.arange(wf, dtype=torch.float32, device=dev) * stride_x
        valid = ((ys[None, :, None] < image_hw[:, 0, None, None])
                 & (xs[None, None, :] < image_hw[:, 1, None, None]))
        pos = sine_position_embedding(valid, d.d_model).to(self.dtype)
        n = hf * wf
        src = src.permute(0, 2, 3, 1).reshape(b, n, d.d_model)
        pos = pos.reshape(b, n, d.d_model)
        key_mask = valid.reshape(b, 1, 1, n)
        for i in range(d.enc_layers):
            src = getattr(self, f"enc{i}")(src, pos, key_mask, generator)
        tgt = torch.zeros((b, d.num_queries, d.d_model), dtype=self.dtype,
                          device=dev)
        qpos = self.query_embed.to(self.dtype)[None].expand(b, -1, -1)
        states = []
        for i in range(d.dec_layers):
            tgt = getattr(self, f"dec{i}")(tgt, qpos, src, pos, key_mask,
                                           generator)
            states.append(self.dec_norm(tgt))
        hs = torch.stack(states)                 # [L, B, Q, d] f32
        logits = self.class_head(hs).float()
        h = F.relu(self.bbox_fc0(hs))
        h = F.relu(self.bbox_fc1(h))
        return logits, torch.sigmoid(self.bbox_out(h).float())


class DETR(nn.Module):
    """Pipeline around :class:`DETRCore`, with the surface of
    ``FasterRCNN``. Runs on ``device`` (CUDA unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, cfg: Config, device="cuda"):
        super().__init__()
        if cfg.rpn_only or cfg.det_only:
            raise ValueError(
                "rpn_only/det_only are two-stage (Faster R-CNN) training "
                "modes; DETR has neither an RPN nor a second stage")
        if cfg.backbone.use_fpn:
            raise ValueError(
                "model='detr' consumes the single-scale C5 feature "
                "(paper §3.3); set backbone.use_fpn=False")
        d = cfg.detr
        if d.d_model % 4:
            raise ValueError(
                f"detr.d_model must be divisible by 4 (the 2-D sine "
                f"embedding splits it into y/x sin/cos quarters), got "
                f"{d.d_model}")
        if d.d_model % d.num_heads:
            raise ValueError(f"detr.d_model {d.d_model} not divisible by "
                             f"num_heads {d.num_heads}")
        if d.num_queries < cfg.data.max_gt_boxes:
            raise ValueError(
                f"detr.num_queries ({d.num_queries}) must be >= "
                f"data.max_gt_boxes ({cfg.data.max_gt_boxes}): the "
                f"Hungarian matcher assigns every (padded) GT row a "
                f"distinct query")
        self.cfg = cfg
        self.device = torch.device(device)
        self.core = DETRCore(cfg, self.device)

    def init(self, seed: int = 0) -> "DETR":
        """Draw every weight from ``seed`` with the Flax initializers'
        distributions (the numbers differ from JAX's): lecun-normal kernels,
        zero biases, the query embedding normal(1)."""
        generator = torch.Generator().manual_seed(seed)
        init_module(self.core, generator)
        normal_(self.core.query_embed, 1.0, generator)
        return self

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             dp=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The set loss on a preprocessed batch (``image``, ``image_hw``,
        ``gt_boxes [B, G, 4]`` xyxy pixels, ``gt_classes`` 1..C,
        ``gt_valid``) -> ``(total, metrics)``, as ``tpudet.models.DETR.loss``:
        ground truth in normalized cxcywh by each image's true extent, the
        set loss per (decoder layer, image) -- the last layer only without
        ``aux_loss`` -- the CE of each layer divided by the sum of its
        weights over the batch, the box terms by layer 0's matched pairs,
        the weighted per-layer sums added up. Dropout runs when the model is
        in training mode and ``detr.dropout > 0``; its masks come from
        ``generator`` (on the model's device), which must then be given.
        With ``dp`` (``parallel.DataParallel``; ``batch`` is this process's
        rows) both normalizers are the group's sums over its world size,
        so that the group's mean gradient is that of the joined batch."""
        d = self.cfg.detr
        if self.training and d.dropout > 0.0:
            if generator is None:
                raise ValueError(
                    f"detr.dropout={d.dropout} in training mode draws its "
                    "masks from a torch.Generator: pass one on "
                    f"{self.device} (or call model.eval())")
        else:
            generator = None
        hw = batch["image_hw"].to(torch.float32)
        logits, boxes = self.core(batch["image"], hw, generator)
        if not d.aux_loss:
            logits, boxes = logits[-1:], boxes[-1:]
        norm = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                           dim=-1)[:, None, :]
        gt_n = box_ops.xyxy_to_cxcywh(batch["gt_boxes"].to(torch.float32)) / norm
        layers = logits.shape[0]
        ce_s, ce_w, l1_s, gi_s, npos = losses.detr_set_loss(
            logits, boxes, gt_n.expand(layers, -1, -1, -1),
            batch["gt_classes"].expand(layers, -1, -1),
            batch["gt_valid"].to(torch.bool).expand(layers, -1, -1),
            cost_class=d.cost_class, cost_bbox=d.cost_bbox,
            cost_giou=d.cost_giou, eos_coef=d.eos_coef)
        total_pos = npos[0].sum()
        ce_weight = ce_w.sum(dim=1)                           # [L]
        if dp is not None:
            total_pos = dp.all_reduce_sum(total_pos) / dp.world_size
            ce_weight = dp.all_reduce_sum(ce_weight) / dp.world_size
        total_pos = total_pos.clamp(min=1.0)
        cls_loss = ce_s.sum(dim=1) / ce_weight
        l1_loss = l1_s.sum(dim=1) / total_pos
        giou_loss = gi_s.sum(dim=1) / total_pos
        layer_losses = (d.loss_weight_class * cls_loss
                        + d.loss_weight_bbox * l1_loss
                        + d.loss_weight_giou * giou_loss)
        total = layer_losses.sum()
        return total, {
            "loss": total,
            "class_ce_loss": cls_loss[-1],
            "l1_box_loss": l1_loss[-1],
            "giou_box_loss": giou_loss[-1],
            "num_gt": npos[-1].mean(),
        }

    def _predict_single(self, logits: torch.Tensor, boxes_n: torch.Tensor,
                        image_hw: torch.Tensor):
        """The paper's eval protocol for ``[B, Q, C + 1]`` logits: the
        softmax over every column, the no-object column then dropped, a
        top-k over the flattened (query, class) posteriors in ``lax.top_k``'s
        tie order, boxes decoded by each image's true extent and clipped;
        scores and classes zeroed below ``score_thresh``. No NMS."""
        d = self.cfg.detr
        num_classes = self.cfg.data.num_classes
        b = logits.shape[0]
        flat = torch.softmax(logits, dim=-1)[..., 1:].reshape(b, -1)
        k = min(d.max_detections, flat.shape[1])
        scores, idx = selection.top_k(flat, k)
        query = torch.div(idx, num_classes, rounding_mode="floor")
        classes = (idx % num_classes).to(torch.int32) + 1
        hw = image_hw.to(torch.float32)
        norm = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], dim=-1)
        picked = torch.gather(boxes_n, 1, query[..., None].expand(-1, -1, 4))
        boxes = box_ops.cxcywh_to_xyxy(picked) * norm[:, None, :]
        boxes = box_ops.clip_boxes(boxes, hw[:, None, :])
        valid = scores > d.score_thresh
        return (boxes, torch.where(valid, scores, torch.zeros_like(scores)),
                torch.where(valid, classes, torch.zeros_like(classes)), valid)

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Inference on a preprocessed batch (``image [B, H, W, 3]``,
        ``image_hw [B, 2]``) -> ``boxes [B, D, 4]``, ``scores [B, D]``,
        ``classes [B, D]`` (1..C), ``valid [B, D]``, ``num_detections [B]``."""
        image_hw = batch["image_hw"].to(torch.float32)
        logits, boxes_n = self.core(batch["image"], image_hw)
        boxes, scores, classes, valid = self._predict_single(
            logits[-1], boxes_n[-1], image_hw)
        return {
            "boxes": boxes,
            "scores": scores,
            "classes": classes,
            "valid": valid,
            "num_detections": valid.sum(dim=1, dtype=torch.int32),
        }
