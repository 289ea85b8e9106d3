"""DETR parts that Deformable DETR reuses (``tpudet.models.detr``): the 2-D
sine positional embedding, the FFN, and multi-head attention in Flax's
parameter layout, each with Flax's dropout sites (active only when a
``torch.Generator`` is passed: see ``layers.dropout``). The DETR model
itself waits for its slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.models.layers import Dense, dropout


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
    """``fc1`` -> ReLU -> dropout -> ``fc2``, computing in ``dtype``."""

    def __init__(self, d_model: int, ffn_dim: int, dtype: torch.dtype,
                 device=None, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.fc1 = Dense(d_model, ffn_dim, dtype=dtype, device=device)
        self.fc2 = Dense(ffn_dim, d_model, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.relu(self.fc1(x)), self.dropout, generator)
        return self.fc2(h)


class MultiHeadDotProductAttention(nn.Module):
    """Flax's ``nn.MultiHeadDotProductAttention`` (no mask):
    ``query``/``key``/``value`` projections to ``heads x head_dim``, the
    query scaled by ``1/sqrt(head_dim)`` (rounded to ``dtype``) before
    ``q·kᵀ``, a softmax over keys, dropout on the probabilities (Flax's
    ``broadcast_dropout``: one ``[q, k]`` mask for every image and head,
    the multiplier ``keep / keep_prob`` in ``dtype``), and the ``out``
    projection, all in ``dtype``. Flax keeps the projections as ``DenseGeneral`` kernels
    ``[d, heads, hd]`` (``out``: ``[heads, hd, d]``); here each is a Linear
    over the flattened ``heads * hd`` axis (``models.import_weights`` maps
    them)."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 device=None, dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.query = Dense(d_model, d_model, dtype=dtype, device=device)
        self.key = Dense(d_model, d_model, dtype=dtype, device=device)
        self.value = Dense(d_model, d_model, dtype=dtype, device=device)
        self.out = Dense(d_model, d_model, dtype=dtype, device=device)

    def forward(self, inputs_q: torch.Tensor, inputs_k: torch.Tensor,
                inputs_v: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, nq, d = inputs_q.shape
        nk = inputs_k.shape[1]
        h = self.num_heads
        hd = d // h
        q = self.query(inputs_q).reshape(b, nq, h, hd)
        k = self.key(inputs_k).reshape(b, nk, h, hd)
        v = self.value(inputs_v).reshape(b, nk, h, hd)
        root = torch.tensor(math.sqrt(hd), dtype=torch.float32,
                            device=q.device).to(q.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q / root, k)
        attn = torch.softmax(logits, dim=-1)
        rate = self.dropout_rate
        if generator is not None and rate > 0.0:
            keep_prob = 1.0 - rate
            keep = torch.rand((1, 1) + attn.shape[-2:], generator=generator,
                              device=attn.device) < keep_prob
            attn = attn * (keep.to(attn.dtype) / torch.tensor(
                keep_prob, dtype=attn.dtype, device=attn.device))
        x = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out(x.reshape(b, nq, d))
