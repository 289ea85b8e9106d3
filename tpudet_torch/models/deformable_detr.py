"""Deformable DETR (``tpudet.models.deformable_detr``; Zhu et al.,
arXiv:2010.04159): inference and the training loss.

The backbone's C3..C5 and extra stride-2 levels are projected to
``d_model``, normalized over their valid positions only and flattened into
one multi-scale token sequence. A post-norm encoder of deformable
self-attention and a decoder of dense query self-attention plus deformable
cross-attention follow; each decoder layer's heads give sigmoid class
logits and (cx, cy, w, h) boxes around the layer's reference points
(re-estimated layer by layer under ``with_box_refine``, each layer's
reference detached from the previous layer's boxes). Inference is a top-k
over the (query, class) sigmoid scores: no NMS. Training matches queries to
ground truth per decoder layer and image (``train.losses``), with dropout
at Flax's sites when the model is in training mode and a generator is
passed.

Every multi-scale deformable attention runs through
``tpudet_torch.kernels.deform_attn`` (the Hopper kernels on the card, its
plain version on the CPU): one forward launch per ``MSDeformAttn`` call, 12
per predict or train step at 6+6 layers, and one backward launch per call in
a train step.

Dtypes follow the JAX package's flow: the value projection, ``out``, the
FFN, the dense attention and the box MLP's first two layers compute in the
model dtype; the offset and attention-weight layers, the reference-point
head, the class heads and the box MLP's last layer compute in f32 over an
f32 input. Flax's LayerNorm returns f32, so in the bf16 preset the
residual stream is f32 after the first norm and every bf16 layer casts its
input down again.

Module names follow the Flax tree (``enc0.deform_attn.sampling_offsets``,
``dec0.self_attn.query``, ``class_head0``, ``bbox_head0.fc0``,
``input_proj0``, ``extra_norm0``, ``level_embed``, ``query_embed``, ...), so
a converted variables tree loads by name.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.config import Config
from tpudet_torch.kernels import deform_attn as deform_attn_kernel
from tpudet_torch.models.detr import (
    MultiHeadDotProductAttention,
    _FFN,
    sine_position_embedding,
)
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
from tpudet_torch.ops.deform_attn import (
    inverse_sigmoid,
    level_reference_points,
    sampling_offset_init_bias,
)
from tpudet_torch.train import losses
from tpudet_torch.utils.profiling import span

GATHERS = ("flat", "patch", "mxu")
LevelShapes = Tuple[Tuple[int, int], ...]


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as an f32 tensor on ``like``'s device: dividing by it is a
    true division on the card too (a Python scalar divisor becomes a
    reciprocal multiply there)."""
    return torch.tensor(float(value), dtype=torch.float32, device=like.device)


class MaskedGroupNorm(nn.Module):
    """GroupNorm whose statistics cover valid positions only (canvas padding
    excluded), epsilon 1e-5, over NHWC input; statistics in f32, output in
    the input's dtype."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """``x [B, H, W, C]``, ``valid [B, H, W]`` bool."""
        b, h, w, c = x.shape
        g = self.num_groups
        xf = x.to(torch.float32).reshape(b, h * w, g, c // g)
        m = valid.reshape(b, h * w, 1, 1).to(torch.float32)
        n = (m.sum(dim=1, keepdim=True) * (c // g)).clamp(min=1.0)
        mean = (xf * m).sum(dim=(1, 3), keepdim=True) / n
        var = ((xf - mean).square() * m).sum(dim=(1, 3), keepdim=True) / n
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(b, h, w, c)
        return (y * self.weight + self.bias).to(x.dtype)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (paper §4.1): sampling offsets and
    attention weights linear in the query, values linear in the flattened
    multi-scale memory, sampling through the kernel. ``gather`` names one
    of the JAX package's three formulations of the same function; all reach
    the one op here.

    ``shared_locations`` (Lite-DETR-style, the JAX package's model variant;
    it requires ``gather="patch"``): the offsets layer loses its head axis
    (``Dense(L * P * 2)``, its bias a directional probe that spreads the P
    points over the angles 2πk/P at radius 1), and the ``[B, Nq, L, P, 2]``
    locations are broadcast over the heads. The JAX function is then the
    per-head function with every head's locations equal, so here the
    locations are expanded to ``[B, Nq, H, L, P, 2]`` (made contiguous for
    the kernel) and go through the same forward and backward kernels;
    autograd of the expand sums their gradient over the heads.

    Under tensor parallelism (``layers.shard_model``) ``value`` is column-
    and ``out`` row-parallel and a rank samples ``num_heads / size`` heads:
    the replicated offsets and attention weights are cut to its heads
    (``TensorParallel.split``, whose backward sums the heads' gradients over
    the model group) and made contiguous for the kernel; the reference
    points (the shared locations) reach its heads only, so their gradient
    is summed over the model group too (``TensorParallel.copy``)."""

    def __init__(self, d_model: int, num_heads: int, num_levels: int,
                 num_points: int, dtype: torch.dtype, gather: str = "flat",
                 shared_locations: bool = False, device=None):
        super().__init__()
        if gather not in GATHERS:
            raise ValueError(f"sampling_gather={gather!r}: expected one of "
                             f"{GATHERS}")
        if shared_locations and gather != "patch":
            raise ValueError(
                "shared_locations requires the patch gather formulation")
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.shared_locations = shared_locations
        self.dtype = dtype
        self.tp = None
        samples = num_heads * num_levels * num_points
        self.value = Dense(d_model, d_model, dtype=dtype, device=device)
        self.sampling_offsets = Dense(
            d_model, (samples // num_heads if shared_locations else samples)
            * 2, device=device)
        self.attention_weights = Dense(d_model, samples, device=device)
        self.out = Dense(d_model, d_model, dtype=dtype, device=device)

    def shard_tp(self, tp) -> None:
        if self.value.tp is not None:
            if self.num_heads % tp.size:
                raise ValueError(f"{self.num_heads} heads over a model axis "
                                 f"of {tp.size}")
            self.tp = tp

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The official init: offset kernel zero with the directional-probe
        bias, attention-weight layer zero (uniform after the softmax)."""
        del generator
        lv, p = self.num_levels, self.num_points
        if self.shared_locations:
            probe = sampling_offset_init_bias(p, lv, 1).reshape(p, lv, 2)
            bias = probe.permute(1, 0, 2).reshape(-1)
        else:
            bias = sampling_offset_init_bias(self.num_heads, lv, p)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(bias)
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, ref_xy: torch.Tensor,
                ref_wh: Optional[torch.Tensor], memory: torch.Tensor,
                valid_tokens: torch.Tensor,
                level_shapes: LevelShapes) -> torch.Tensor:
        """``query [B, Nq, d]``; ``ref_xy [B, Nq, L, 2]`` full-grid-normalized
        (x, y); ``ref_wh`` the box (w, h) in the same frame, or None for
        point references; ``memory [B, N, d]``; ``valid_tokens [B, N]``
        (padded tokens' values are zeroed, so a sample on canvas padding
        contributes what an out-of-grid sample does: nothing)."""
        h, lv, p = self.num_heads, self.num_levels, self.num_points
        b, nq, d = query.shape
        hd = d // h
        local = h if self.tp is None else h // self.tp.size
        value = self.value(memory)
        value = value.masked_fill(~valid_tokens[..., None], 0.0)
        value = value.reshape(b, -1, local, hd)
        q32 = query.to(torch.float32)
        attn = self.attention_weights(q32).reshape(b, nq, h, lv * p)
        # Locations [B, Nq, L, P, 2] (shared) or [B, Nq, H, L, P, 2]; the
        # reference and the level sizes broadcast over the points (and the
        # heads).
        if self.shared_locations:
            offsets = self.sampling_offsets(q32).reshape(b, nq, lv, p, 2)
            at = (slice(None), slice(None), slice(None), None)
        else:
            offsets = self.sampling_offsets(q32).reshape(b, nq, h, lv, p, 2)
            if self.tp is not None:
                offsets = self.tp.split(offsets, 2)
                ref_xy = self.tp.copy(ref_xy)
                ref_wh = None if ref_wh is None else self.tp.copy(ref_wh)
            at = (slice(None), slice(None), None, slice(None), None)
        if self.tp is not None:
            attn = self.tp.split(attn, 2)
        attn = torch.softmax(attn, dim=-1).reshape(b, nq, local, lv, p)
        ref = ref_xy[at]
        if ref_wh is None:
            # Point reference: offsets in pixels of each level's grid.
            normalizer = torch.tensor([[wl, hl] for hl, wl in level_shapes],
                                      dtype=torch.float32, device=query.device)
            loc = ref + offsets / normalizer[(None, None) + at[2:]]
        else:
            # Box reference: offset / P * (w, h) / 2.
            loc = ref + offsets / _scalar(p, offsets) * ref_wh[at] * 0.5
        if self.shared_locations:
            if self.tp is not None:
                loc = self.tp.copy(loc)
            loc = loc[:, :, None].expand(b, nq, local, lv, p, 2)
        out = deform_attn_kernel.ms_deform_attn(value.contiguous(),
                                                level_shapes,
                                                loc.contiguous(), attn)
        return self.out(out.reshape(b, nq, local * hd).to(self.dtype))


class DeformableEncoderLayer(nn.Module):
    """Post-norm encoder layer: deformable self-attention over the
    multi-scale tokens (query = token + positional/level embedding,
    reference = the token's own center), then the FFN; dropout on both
    branches and inside the FFN when a generator is passed."""

    def __init__(self, d_model, num_heads, num_levels, num_points, ffn_dim,
                 dtype, gather="flat", shared_locations=False, device=None,
                 dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.deform_attn = MSDeformAttn(d_model, num_heads, num_levels,
                                        num_points, dtype, gather,
                                        shared_locations, device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.ffn = _FFN(d_model, ffn_dim, dtype, device, dropout)
        self.norm2 = LayerNorm(d_model, device=device)

    def forward(self, src, pos, ref_xy, valid_tokens, level_shapes,
                generator=None):
        attn = self.deform_attn(src + pos, ref_xy, None, src, valid_tokens,
                                level_shapes)
        src = self.norm1(src + dropout(attn, self.dropout, generator))
        ffn = self.ffn(src, generator)
        return self.norm2(src + dropout(ffn, self.dropout, generator))


class DeformableDecoderLayer(nn.Module):
    """Post-norm decoder layer: dense query self-attention (q = k =
    tgt + query_pos, v = tgt), deformable cross-attention into the
    multi-scale memory, the FFN; dropout on the attention probabilities,
    on the three branches and inside the FFN when a generator is passed."""

    def __init__(self, d_model, num_heads, num_levels, num_points, ffn_dim,
                 dtype, gather="flat", shared_locations=False, device=None,
                 dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadDotProductAttention(d_model, num_heads,
                                                      dtype, device, dropout)
        self.norm1 = LayerNorm(d_model, device=device)
        self.cross_attn = MSDeformAttn(d_model, num_heads, num_levels,
                                       num_points, dtype, gather,
                                       shared_locations, device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.ffn = _FFN(d_model, ffn_dim, dtype, device, dropout)
        self.norm3 = LayerNorm(d_model, device=device)

    def forward(self, tgt, query_pos, memory, ref_xy, ref_wh, valid_tokens,
                level_shapes, generator=None):
        rate = self.dropout
        q = tgt + query_pos
        attn = self.self_attn(q, q, tgt, generator)
        tgt = self.norm1(tgt + dropout(attn, rate, generator))
        attn = self.cross_attn(tgt + query_pos, ref_xy, ref_wh, memory,
                               valid_tokens, level_shapes)
        tgt = self.norm2(tgt + dropout(attn, rate, generator))
        ffn = self.ffn(tgt, generator)
        return self.norm3(tgt + dropout(ffn, rate, generator))


class _BoxMLP(nn.Module):
    """3-layer box head (d -> d -> d -> 4); the last layer in f32."""

    def __init__(self, d_model: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.fc0 = Dense(d_model, d_model, dtype=dtype, device=device)
        self.fc1 = Dense(d_model, d_model, dtype=dtype, device=device)
        self.out = Dense(d_model, 4, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc0(x))
        x = F.relu(self.fc1(x))
        return self.out(x.to(torch.float32))


class DeformableDETRCore(nn.Module):
    """Backbone C3..C5 (+ extra strided levels) -> per-level projections ->
    deformable encoder -> deformable decoder -> per-layer heads."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        bb = cfg.backbone
        d = cfg.deformable_detr
        dtype = torch.bfloat16 if bb.dtype == "bfloat16" else torch.float32
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = build_backbone(bb.name, bb.norm, dtype,
                                       bb.stride_in_1x1, device,
                                       freeze_stem=bb.freeze_stem,
                                       s2d_stem=bb.s2d_stem, remat=bb.remat)
        channels = self.backbone.channels
        groups = min(32, d.d_model)
        # 1x1 conv + masked GroupNorm on C3..C5; each extra level a 3x3/2
        # conv with explicit (1, 1) padding ("SAME" would pad by the input's
        # parity and misalign the grid between aspect buckets) on the
        # previous one, the first on the raw C5.
        for i, name in enumerate(("c3", "c4", "c5")):
            self.add_module(f"input_proj{i}", Conv(
                channels[name], d.d_model, 1, dtype=dtype, device=device))
            self.add_module(f"input_norm{i}", MaskedGroupNorm(
                groups, d.d_model, device=device))
        in_ch = channels["c5"]
        for i in range(d.num_levels - 3):
            self.add_module(f"extra_proj{i}", Conv(
                in_ch, d.d_model, 3, 2, padding=1, dtype=dtype, device=device))
            self.add_module(f"extra_norm{i}", MaskedGroupNorm(
                groups, d.d_model, device=device))
            in_ch = d.d_model
        self.level_embed = nn.Parameter(
            torch.zeros(d.num_levels, d.d_model, device=device))
        layer = dict(d_model=d.d_model, num_heads=d.num_heads,
                     num_levels=d.num_levels, num_points=d.num_points,
                     ffn_dim=d.ffn_dim, dtype=dtype, gather=d.sampling_gather,
                     shared_locations=d.shared_sampling_locations,
                     device=device, dropout=d.dropout)
        for i in range(d.enc_layers):
            self.add_module(f"enc{i}", DeformableEncoderLayer(**layer))
        for i in range(d.dec_layers):
            self.add_module(f"dec{i}", DeformableDecoderLayer(**layer))
        # Queries carry (positional embedding, content init) halves; the
        # initial reference point is linear in the positional half.
        self.query_embed = nn.Parameter(
            torch.zeros(d.num_queries, 2 * d.d_model, device=device))
        self.ref_point_head = Dense(d.d_model, 2, device=device)
        # Per-layer heads under box refinement, one shared head otherwise.
        self.num_head_sets = d.dec_layers if d.with_box_refine else 1
        for i in range(self.num_head_sets):
            self.add_module(f"class_head{i}", Dense(
                d.d_model, cfg.data.num_classes, device=device))
            self.add_module(f"bbox_head{i}", _BoxMLP(d.d_model, dtype, device))

    def _layers(self, prefix: str, count: int):
        return [getattr(self, f"{prefix}{i}") for i in range(count)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's initializers where they differ from lecun-normal kernels
        and zero biases (which ``init_module`` draws): the embeddings
        normal(1), the offset and attention-weight layers, the focal prior
        on the class heads, a zero last box layer, the masked GroupNorms."""
        normal_(self.level_embed, 1.0, generator)
        normal_(self.query_embed, 1.0, generator)
        prior_bias = -math.log((1.0 - 0.01) / 0.01)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (MSDeformAttn, MaskedGroupNorm)):
                    m.reset_parameters(generator)
            for i in range(self.num_head_sets):
                getattr(self, f"class_head{i}").bias.fill_(prior_bias)
                box_out = getattr(self, f"bbox_head{i}").out
                box_out.weight.zero_()
                box_out.bias.zero_()

    # ------------------------------------------------------------ features
    def _multi_scale(self, images: torch.Tensor, image_hw: torch.Tensor):
        """Backbone -> L projected levels as tokens ``[B, N, d]``, with
        positional embeddings, validity ``[B, N]``, the level shapes and the
        per-level valid ratios ``[B, L, 2]`` as (w, h)."""
        d = self.cfg.deformable_detr
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        feats = self.backbone(x, stop_at="c5")
        maps = [proj(feats[name]) for proj, name in zip(
            self._layers("input_proj", 3), ("c3", "c4", "c5"))]
        x = feats["c5"]
        for proj in self._layers("extra_proj", d.num_levels - 3):
            x = proj(x)
            maps.append(x)
        norms = (self._layers("input_norm", 3)
                 + self._layers("extra_norm", d.num_levels - 3))
        b = images.shape[0]
        dev = images.device
        level_shapes, tokens, poss, valids, ratios = [], [], [], [], []
        for li, m in enumerate(maps):
            m = m.permute(0, 2, 3, 1)  # NHWC
            hf, wf = m.shape[1:3]
            level_shapes.append((hf, wf))
            # The architectural stride (C3 = 8, doubling per level), not
            # canvas / grid: an extra level need not tile the canvas.
            stride = 8 * (2 ** li)
            ys = torch.arange(hf, dtype=torch.float32, device=dev) * stride
            xs = torch.arange(wf, dtype=torch.float32, device=dev) * stride
            valid = ((ys[None, :, None] < image_hw[:, 0, None, None])
                     & (xs[None, None, :] < image_hw[:, 1, None, None]))
            m = norms[li](m, valid)
            pos = sine_position_embedding(valid, d.d_model).to(self.dtype)
            pos = pos + self.level_embed[li].to(self.dtype)
            tokens.append(m.reshape(b, hf * wf, d.d_model))
            poss.append(pos.reshape(b, hf * wf, d.d_model))
            valids.append(valid.reshape(b, hf * wf))
            # Valid fraction of the grid per axis, fractional by design.
            vh = (image_hw[:, 0] / _scalar(stride * hf, image_hw)).clamp(max=1.0)
            vw = (image_hw[:, 1] / _scalar(stride * wf, image_hw)).clamp(max=1.0)
            ratios.append(torch.stack([vw, vh], dim=-1))
        return (torch.cat(tokens, dim=1), torch.cat(poss, dim=1),
                torch.cat(valids, dim=1), tuple(level_shapes),
                torch.stack(ratios, dim=1))

    # ------------------------------------------------------------- forward
    def forward(self, images: torch.Tensor, image_hw: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, H, W, 3]`` images, ``[B, 2]`` f32 (h, w) -> per decoder
        layer ``[Ldec, B, Q, C]`` class logits and ``[Ldec, B, Q, 4]``
        (cx, cy, w, h) boxes normalized by each image's true extent.
        ``generator`` (None: no dropout) draws every dropout mask."""
        d = self.cfg.deformable_detr
        with span("tpudet/backbone"):
            src, pos, valid_tokens, level_shapes, valid_ratios = (
                self._multi_scale(images, image_hw))
        b = src.shape[0]

        with span("tpudet/encoder"):
            # Encoder references: each token's own center in
            # valid-normalized coordinates, scaled into every level's full
            # grid by its ratio.
            centers = level_reference_points(level_shapes, device=src.device)
            own_ratio = torch.cat([
                valid_ratios[:, li:li + 1, :].expand(b, hl * wl, 2)
                for li, (hl, wl) in enumerate(level_shapes)], dim=1)
            ref_valid = centers[None] / own_ratio.clamp(min=1e-6)
            enc_ref = ref_valid[:, :, None, :] * valid_ratios[:, None, :, :]
            for layer in self._layers("enc", d.enc_layers):
                src = layer(src, pos, enc_ref, valid_tokens, level_shapes,
                            generator)
        with span("tpudet/decoder"):
            qe = self.query_embed
            qpos = qe[None, :, :d.d_model].expand(b, -1, -1).to(self.dtype)
            tgt = qe[None, :, d.d_model:].expand(b, -1, -1).to(self.dtype)
            ref = torch.sigmoid(self.ref_point_head(qpos.to(torch.float32)))

            all_logits, all_boxes = [], []
            for i, layer in enumerate(self._layers("dec", d.dec_layers)):
                if ref.shape[-1] == 2:
                    ref_xy = ref[:, :, None, :] * valid_ratios[:, None, :, :]
                    ref_wh = None
                else:
                    scaled = ref[:, :, None, :] * torch.cat(
                        [valid_ratios, valid_ratios], dim=-1)[:, None, :, :]
                    ref_xy, ref_wh = scaled[..., :2], scaled[..., 2:]
                tgt = layer(tgt, qpos, src, ref_xy, ref_wh, valid_tokens,
                            level_shapes, generator)
                hi = i if d.with_box_refine else 0
                logits = getattr(self, f"class_head{hi}")(
                    tgt.to(torch.float32))
                delta = getattr(self, f"bbox_head{hi}")(tgt)
                if ref.shape[-1] == 2:
                    anchor = torch.cat([inverse_sigmoid(ref),
                                        torch.zeros_like(ref)], dim=-1)
                else:
                    anchor = inverse_sigmoid(ref)
                boxes = torch.sigmoid(delta + anchor)
                all_logits.append(logits)
                all_boxes.append(boxes)
                if d.with_box_refine:
                    # Each layer refines around the previous layer's boxes
                    # without backpropagating into them.
                    ref = boxes.detach()
            return torch.stack(all_logits), torch.stack(all_boxes)


class DeformableDETR(nn.Module):
    """Pipeline around :class:`DeformableDETRCore`, with the surface of
    ``FasterRCNN``. Runs on ``device`` (CUDA unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, cfg: Config, device="cuda"):
        super().__init__()
        if cfg.rpn_only:
            raise ValueError(
                "rpn_only is a two-stage (Faster R-CNN) mode; Deformable DETR "
                "has no RPN")
        if cfg.backbone.use_fpn:
            raise ValueError(
                "model='deformable_detr' builds its own multi-scale "
                "projections from C3..C5 (paper §4.3); set "
                "backbone.use_fpn=False")
        d = cfg.deformable_detr
        if d.num_levels < 3:
            raise ValueError(f"deformable_detr.num_levels must be >= 3 "
                             f"(C3..C5), got {d.num_levels}")
        if d.d_model % 4:
            raise ValueError(
                f"deformable_detr.d_model must be divisible by 4 (the 2-D "
                f"sine embedding splits it into y/x sin/cos quarters), got "
                f"{d.d_model}")
        if d.d_model % d.num_heads:
            raise ValueError(f"deformable_detr.d_model {d.d_model} not "
                             f"divisible by num_heads {d.num_heads}")
        if d.num_queries < cfg.data.max_gt_boxes:
            raise ValueError(
                f"deformable_detr.num_queries ({d.num_queries}) must be >= "
                f"data.max_gt_boxes ({cfg.data.max_gt_boxes}): the Hungarian "
                "matcher assigns every (padded) GT row a distinct query")
        self.cfg = cfg
        self.device = torch.device(device)
        self.core = DeformableDETRCore(cfg, self.device)

    def init(self, seed: int = 0) -> "DeformableDETR":
        """Draw every weight from ``seed`` with the Flax initializers'
        distributions (the numbers differ from JAX's)."""
        generator = torch.Generator().manual_seed(seed)
        init_module(self.core, generator)
        self.core.reset_parameters(generator)
        return self

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             dp=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The set loss on a preprocessed batch (``image``, ``image_hw``,
        ``gt_boxes [B, G, 4]`` xyxy pixels, ``gt_classes [B, G]`` 1..C,
        ``gt_valid [B, G]``) -> ``(total, metrics)``, as
        ``tpudet.models.DeformableDETR.loss``: ground truth in normalized
        cxcywh by each image's true extent, the focal-matched set loss per
        (decoder layer, image) -- the last layer only without ``aux_loss``
        -- each term over layer 0's matched pairs, the weighted per-layer
        sums added up. Dropout runs when the model is in training mode and
        ``deformable_detr.dropout > 0``; its masks come from ``generator``
        (on the model's device), which must then be given. With ``dp``
        (``parallel.DataParallel``; ``batch`` is this process's rows) the
        terms divide by the group's matched count over its world size, so
        that the group's mean gradient is that of the joined batch, as
        ``pjit``'s global sum gives it."""
        cfg = self.cfg
        d = cfg.deformable_detr
        if self.training and d.dropout > 0.0:
            if generator is None:
                raise ValueError(
                    f"deformable_detr.dropout={d.dropout} in training mode "
                    "draws its masks from a torch.Generator: pass one on "
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
        with span("tpudet/set_loss"):
            focal_s, l1_s, gi_s, npos = losses.deformable_detr_set_loss(
                logits, boxes, gt_n.expand(layers, -1, -1, -1),
                batch["gt_classes"].expand(layers, -1, -1),
                batch["gt_valid"].to(torch.bool).expand(layers, -1, -1),
                cost_class=d.cost_class, cost_bbox=d.cost_bbox,
                cost_giou=d.cost_giou, alpha=d.focal_alpha,
                gamma=d.focal_gamma)
        # Every term over the matched pairs of the batch (layer 0's count).
        total_pos = npos[0].sum()
        if dp is not None:
            total_pos = (dp.all_reduce_sum(total_pos).clamp(min=1.0)
                         / dp.world_size)
        else:
            total_pos = total_pos.clamp(min=1.0)
        cls_loss = focal_s.sum(dim=1) / total_pos             # [Ldec]
        l1_loss = l1_s.sum(dim=1) / total_pos
        giou_loss = gi_s.sum(dim=1) / total_pos
        layer_losses = (d.loss_weight_class * cls_loss
                        + d.loss_weight_bbox * l1_loss
                        + d.loss_weight_giou * giou_loss)
        total = layer_losses.sum()
        return total, {
            "loss": total,
            "focal_cls_loss": cls_loss[-1],
            "l1_box_loss": l1_loss[-1],
            "giou_box_loss": giou_loss[-1],
            "num_gt": npos[-1].mean(),
        }

    def _predict_single(self, logits: torch.Tensor, boxes_n: torch.Tensor,
                        image_hw: torch.Tensor):
        """The paper's eval protocol, for ``[B, Q, C]`` logits and
        ``[B, Q, 4]`` boxes: top-k over the flattened (query, class) sigmoid
        scores with ``lax.top_k``'s tie order (lower index first), decode by
        the image's true extent, clip. No NMS."""
        d = self.cfg.deformable_detr
        num_classes = self.cfg.data.num_classes
        b = logits.shape[0]
        flat = torch.sigmoid(logits).reshape(b, -1)
        k = min(d.max_detections, flat.shape[1])
        scores, idx = selection.top_k(flat, k)
        query = idx // num_classes
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
        ``image_hw [B, 2]`` f32) -> ``boxes [B, D, 4]``, ``scores [B, D]``,
        ``classes [B, D]`` (1..C), ``valid [B, D]``, ``num_detections [B]``."""
        image_hw = batch["image_hw"].to(torch.float32)
        logits, boxes_n = self.core(batch["image"], image_hw)
        with span("tpudet/postprocess"):
            boxes, scores, classes, valid = self._predict_single(
                logits[-1], boxes_n[-1], image_hw)
        return {
            "boxes": boxes,
            "scores": scores,
            "classes": classes,
            "valid": valid,
            "num_detections": valid.sum(dim=1, dtype=torch.int32),
        }
