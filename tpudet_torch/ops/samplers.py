"""Fixed-size balanced minibatch sampling (``tpudet.ops.samplers``).

Faster R-CNN §3.1.3 / Fast R-CNN §2.3: ``K`` examples per image with at
most ``positive_fraction * K`` random positives, the rest random negatives.
As in the JAX package, one static top-k over random priorities does it:

    priority = 2 + u  for the chosen positives (at most K_pos, at random)
               1 + u  for every negative
               0      for ignored labels

``top_k(priority, K)`` gives min(#pos, K_pos) positives, then random
negatives, with a validity mask where there are fewer than K candidates.

The JAX package draws its two uniforms with ``jax.random``, a stream torch
cannot repeat, so here they are inputs (``pos_draws``, ``tie_draws``, each
``[B, N]`` f32), drawn by :func:`draw_uniforms` from an explicit
``torch.Generator`` or handed in by a test. The arithmetic is JAX's in f32
(``2 + u`` rounds, so priorities tie) and both top-ks keep ``lax.top_k``'s
tie order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpudet_torch.ops.selection import top_k


def draw_uniforms(generator: torch.Generator, b: int, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pos_draws, tie_draws)``, each ``[b, n]`` f32 U[0, 1) from
    ``generator`` on its own device."""
    dev = generator.device
    return (torch.rand((b, n), generator=generator, device=dev),
            torch.rand((b, n), generator=generator, device=dev))


def sample_balanced(
    labels: torch.Tensor,
    pos_draws: torch.Tensor,
    tie_draws: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample from ``[B, N]`` labels (1 positive, 0 negative, -1 ignored)
    -> ``(indices [B, K] int32, is_positive [B, K], valid [B, K])``; invalid
    slots point at index 0."""
    k = num_samples
    k_pos = int(round(num_samples * positive_fraction))
    is_pos = labels == 1
    is_neg = labels == 0

    # Up to k_pos positives at random: the top k_pos of their draws (the
    # others at -1 pad the top-k when there are fewer), scattered back.
    pos_rand = torch.where(is_pos, pos_draws, torch.full_like(pos_draws, -1.0))
    _, pos_idx = top_k(pos_rand, k_pos)
    pos_sel = torch.zeros_like(is_pos).scatter(-1, pos_idx, True) & is_pos

    zero = torch.zeros_like(tie_draws)
    priority = torch.where(pos_sel, 2.0 + tie_draws,
                           torch.where(is_neg, 1.0 + tie_draws, zero))
    top_vals, indices = top_k(priority, k)
    valid = top_vals > 0.0
    is_positive = top_vals >= 2.0
    indices = torch.where(valid, indices, torch.zeros_like(indices))
    return indices.to(torch.int32), is_positive, valid
