"""Multi-scale deformable attention sampling, plain PyTorch
(``tpudet.ops.deform_attn``; Zhu et al., Deformable DETR, arXiv:2010.04159
§4.1).

Each query attends to ``points`` bilinearly sampled locations per head per
feature level. Sampling follows ``F.grid_sample(align_corners=False,
padding_mode='zeros')``: the pixel position is ``loc * W_l - 0.5``, and a
corner outside the level grid contributes through a zero weight (its gather
index is clamped so the read stays in bounds).

``ms_deform_attn_batched`` is the gather-then-weighted-sum form and the
plain version of the Hopper kernel in ``tpudet_torch.kernels.deform_attn``:
the CPU path, and the reference the kernel is held against on the card. It
keeps the JAX function's query chunking, so that it also runs on the card
at full size (unchunked, the gathered corners of one 832x832 encoder layer
at b=8 would hold ~3.8 GB in bf16).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def level_start_offsets(level_shapes: Sequence[Tuple[int, int]]):
    """Start offset of each (h, w) level in the concatenated token axis, and
    the total token count."""
    offsets, start = [], 0
    for h, w in level_shapes:
        offsets.append(start)
        start += h * w
    return tuple(offsets), start


def _corner_index_weight(locations: torch.Tensor, weights: torch.Tensor,
                         level_shapes, offsets):
    """Corner gather indices and combined bilinear x attention weights.

    ``locations [..., L, P, 2]`` / ``weights [..., L, P]`` ->
    ``(idx [..., K] int64, cw [..., K] f32)`` with ``K = L*4*P`` in
    (level, corner, point) order. The corner weight is
    ``(fx | 1-fx) * (fy | 1-fy)`` (x factor first), zeroed out of the grid,
    then multiplied by the attention weight: the JAX order, which the CUDA
    kernel repeats."""
    flat_idx, corner_w = [], []
    for li, (hl, wl) in enumerate(level_shapes):
        loc = locations[..., li, :, :]                 # [..., P, 2]
        x = loc[..., 0] * wl - 0.5
        y = loc[..., 1] * hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0 = x0.to(torch.int64)
        y0 = y0.to(torch.int64)
        for dy in (0, 1):
            for dx in (0, 1):
                cx = x0 + dx
                cy = y0 + dy
                wgt = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
                inb = (cx >= 0) & (cx < wl) & (cy >= 0) & (cy < hl)
                cxc = cx.clamp(0, wl - 1)
                cyc = cy.clamp(0, hl - 1)
                flat_idx.append(offsets[li] + cyc * wl + cxc)  # [..., P]
                corner_w.append(torch.where(inb, wgt, torch.zeros_like(wgt)))
    idx = torch.stack(flat_idx, dim=-2)                # [..., L*4, P]
    cw = torch.stack(corner_w, dim=-2)
    # Element (li*4 + corner, p) takes the attention weight (li, p).
    cw = cw * torch.repeat_interleave(weights.to(cw.dtype), 4, dim=-2)
    lead = idx.shape[:-2]
    return idx.reshape(*lead, -1), cw.reshape(*lead, -1)


def ms_deform_attn_batched(
    values: torch.Tensor,       # [B, N, H, D] level-concatenated tokens
    level_shapes: Sequence[Tuple[int, int]],
    locations: torch.Tensor,    # [B, Q, H, L, P, 2] normalized (x, y)
    weights: torch.Tensor,      # [B, Q, H, L, P]
    query_chunk: int = 2048,
) -> torch.Tensor:              # [B, Q, H, D] f32
    """Whole-batch multi-scale deformable attention: one flat gather over a
    ``[B*H*N, D]`` table, then the weighted sum over the ``L*4*P`` corners
    in f32, ``query_chunk`` queries at a time. The gather stays in the
    values' dtype; the sum promotes it to f32, as JAX's einsum does."""
    b, n, h, d = values.shape
    q = locations.shape[1]
    offsets, total = level_start_offsets(level_shapes)
    if total != n:
        raise ValueError(f"level_shapes {tuple(level_shapes)} sum to {total} "
                         f"tokens, values carry {n}")
    idx, cw = _corner_index_weight(locations, weights, level_shapes, offsets)
    table = values.permute(0, 2, 1, 3).reshape(b * h * n, d)
    dev = values.device
    row = (torch.arange(b, device=dev)[:, None, None, None] * h
           + torch.arange(h, device=dev)[None, None, :, None]) * n
    gidx = idx + row                                   # [B, Q, H, K]
    out = []
    for start in range(0, q, query_chunk):
        gi = gidx[:, start:start + query_chunk]
        g = table[gi.reshape(-1)].reshape(*gi.shape, d).float()
        out.append(torch.einsum("bqhk,bqhkd->bqhd",
                                cw[:, start:start + query_chunk], g))
    return torch.cat(out, dim=1) if len(out) > 1 else out[0]


def ms_deform_attn(values: torch.Tensor, level_shapes,
                   locations: torch.Tensor, weights: torch.Tensor
                   ) -> torch.Tensor:
    """One image: ``values [N, H, D]``, ``locations [Q, H, L, P, 2]``,
    ``weights [Q, H, L, P]`` -> ``[Q, H, D]`` f32 (paper Eq. 3); the batched
    form on a batch of one."""
    if locations.shape[1] != values.shape[1] or \
            locations.shape[2] != len(level_shapes):
        raise ValueError("locations/values head or level count mismatch")
    return ms_deform_attn_batched(values[None], level_shapes, locations[None],
                                  weights[None])[0]


def level_reference_points(level_shapes: Sequence[Tuple[int, int]],
                           device=None) -> torch.Tensor:
    """``[N, 2]`` (x, y) normalized centers of every token of every level in
    its own full grid: the encoder's reference points before the valid-ratio
    correction."""
    refs = []
    for hl, wl in level_shapes:
        ys = ((torch.arange(hl, dtype=torch.float32, device=device) + 0.5)
              / torch.tensor(float(hl), device=device))
        xs = ((torch.arange(wl, dtype=torch.float32, device=device) + 0.5)
              / torch.tensor(float(wl), device=device))
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
    return torch.cat(refs, dim=0)


def sampling_offset_init_bias(num_heads: int, num_levels: int,
                              num_points: int) -> torch.Tensor:
    """The paper's sampling-offset bias init: head k looks along 2πk/H, at
    radius p+1 for its p-th point, the same at every level. Shape
    ``[H * L * P * 2]``, the bias layout of the offset layer."""
    thetas = torch.arange(num_heads, dtype=torch.float32) * (
        2.0 * math.pi / num_heads)
    grid = torch.stack([torch.cos(thetas), torch.sin(thetas)], dim=-1)
    grid = grid / grid.abs().amax(dim=-1, keepdim=True)
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    scale = torch.arange(1, num_points + 1, dtype=torch.float32)
    return (grid * scale[None, None, :, None]).reshape(-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Logit with the official implementation's clamping."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps)) - torch.log((1.0 - x).clamp(min=eps))
