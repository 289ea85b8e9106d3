"""Exact blocked top-k (``tpudet.ops.selection.blocked_top_k``).

Any member of the global top-k is inside its own block's top-k, so the
operand is cut into index-contiguous blocks, each block's top ``min(k,
block)`` is taken with one batched sort, and the survivors are merged with
one short top-k. Values, indices and tie order equal one stable descending
sort (``lax.top_k``'s order: equal values by ascending index): within a
block the sort keeps it, and survivors of block b precede those of block
b + 1 in the merge operand, so equal values stay in index order there too.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpudet_torch.ops.nms import sort_desc


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: a stable descending sort, cut."""
    values, indices = sort_desc(scores)
    return values[..., :k], indices[..., :k]


def blocked_top_k(scores: torch.Tensor, k: int, block_size: int = 8192
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis through per-block selection and a merge,
    equal to :func:`top_k`. Falls back to it where blocking cannot win, on
    the JAX package's rules: ``k >= n``, ``n <= block_size``, or a merge
    operand of at least half the input."""
    n = scores.shape[-1]
    if k >= n or n <= block_size:
        return top_k(scores, k)
    nb = -(-n // block_size)
    kb = min(k, block_size)
    if nb * kb * 2 >= n:
        return top_k(scores, k)
    pad = nb * block_size - n
    if pad:
        fill = (torch.finfo(scores.dtype).min if scores.dtype.is_floating_point
                else torch.iinfo(scores.dtype).min)
        scores = torch.cat([scores, scores.new_full(scores.shape[:-1] + (pad,),
                                                    fill)], dim=-1)
    rows = scores.reshape(scores.shape[:-1] + (nb, block_size))
    values, indices = top_k(rows, kb)  # [..., nb, kb]
    offsets = torch.arange(nb, device=scores.device) * block_size
    merged_i = (indices + offsets[:, None]).flatten(-2)
    out_v, sel = top_k(values.flatten(-2), k)
    return out_v, torch.gather(merged_i, -1, sel)
