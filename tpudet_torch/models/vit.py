"""ViTDet: a plain Vision Transformer backbone and the simple feature
pyramid (``tpudet.models.vit``; Li et al., arXiv:2203.16527).

``ViT``: a 16x16 stride-16 patch embedding, a position embedding held on a
fixed ``[1, g, g, D]`` grid and resized to the token grid at call time
(bilinear in f32, antialiased when it shrinks, as ``jax.image.resize``
is), ``depth`` pre-LN blocks (window attention, every
``global_attn_every``-th block global) and a final LayerNorm. The token grid
is NHWC ``[B, H/16, W/16, D]``.

``SimpleFeaturePyramid``: p2..p6 from that one stride-16 map (two 2x2
deconvs with LN and GELU between them for p2, one for p3, the map itself for
p4, a 2x2 max-pool for p5; each then 1x1 conv, LN, 3x3 conv, LN to 256;
p6 the stride-2 subsample of p5). Its output is ``FPN``'s: NCHW maps in
channels-last memory, 256 wide.

Window attention pads the token grid with zeros after ``norm1`` to window
multiples, so the padded tokens take part in attention as keys (as in
upstream ViTDet), and crops back after. The attention logits are f32
products of the q and k of the block dtype, scaled after the product; the
softmax runs in f32 and its probabilities are cast to the block dtype before
the product with v, which accumulates in f32. LayerNorms run in f32 with
Flax's epsilon; the GELUs are exact (erf). Module names follow the Flax
tree (``patch_embed``, ``pos_embed``, ``block{i}.attn.query``, ...,
``up4_deconv1``, ``p2_proj_ln``).

With ``rel_pos`` (``BackboneConfig.vit_rel_pos``) each block adds
detectron2's decomposed relative positions to its logits after the scale:
``rel_h[q, kh] + rel_w[q, kw]``, each the f32 product of the unscaled q
with a learned table of ``[2S - 1, head_dim]`` (S the window in a window
block, ``pos_grid`` in a global one) gathered at the query's and key's
relative offset, the table resized linearly when the token grid is not
S (``get_rel_pos``). The tables are shared by the heads, start at zero, as
detectron2's do, and under tensor parallelism every rank holds them whole.
Each attention core (q, k, v after their projections to the heads' output
before ``out``) is a ``tpudet/attn_window`` or ``tpudet/attn_global`` span.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.models.layers import (
    Conv,
    ConvTranspose,
    Dense,
    LayerNorm,
    run_block,
)
from tpudet_torch.utils.profiling import span

# name -> (embed dim, depth, heads): the paper's variants and a test tiny.
VIT_VARIANTS = {
    "vit_s": (384, 12, 6),
    "vit_b": (768, 12, 12),
    "vit_l": (1024, 24, 16),
    "vit_tiny": (32, 2, 2),
}


def get_rel_pos(q_size: int, k_size: int, table: torch.Tensor
                ) -> torch.Tensor:
    """detectron2's ``get_rel_pos``: ``table`` ``[2S - 1, C]`` resized
    linearly to ``2 * max(q_size, k_size) - 1`` rows where its length
    differs, then gathered at each query and key position's relative offset
    ``i * max(k/q, 1) - j * max(q/k, 1) + (k - 1) * max(q/k, 1)`` -> ``[q_size,
    k_size, C]``."""
    rows = 2 * max(q_size, k_size) - 1
    if table.shape[0] != rows:
        table = F.interpolate(table.t()[None], size=rows, mode="linear")[0].t()
    dev = table.device
    q = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    return table[((q - k) + (k_size - 1) * max(q_size / k_size, 1.0)).long()]


class Attention(nn.Module):
    """Multi-head attention over ``[N, L, D]`` tokens with separate
    ``query``/``key``/``value``/``out`` Dense layers, and with ``rel_pos``
    ``S`` > 0 the decomposed relative-position tables ``rel_pos_h`` and
    ``rel_pos_w`` of ``[2S - 1, head_dim]``. ``window`` names the core's
    span: ``tpudet/attn_window``, or ``tpudet/attn_global`` where it is 0.
    Under tensor parallelism (``layers.shard_model``) the first three are
    column- and ``out`` row-parallel, and a rank computes ``heads / size``
    heads with the whole tables, whose gradient is summed over the model
    group."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype, device=None,
                 rel_pos: int = 0, window: int = 0):
        super().__init__()
        self.heads = heads
        self.local_heads = heads
        self.head_dim = dim // heads
        self.dtype = dtype
        self.scale = (dim // heads) ** -0.5
        self.span_name = ("tpudet/attn_window" if window
                          else "tpudet/attn_global")
        self.tp = None
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(dim, dim, dtype=dtype, device=device))
        self.rel_pos = rel_pos > 0
        if self.rel_pos:
            for name in ("rel_pos_h", "rel_pos_w"):
                self.register_parameter(name, nn.Parameter(torch.zeros(
                    2 * rel_pos - 1, self.head_dim, device=device)))

    def shard_tp(self, tp) -> None:
        if self.value.tp is not None:
            if self.heads % tp.size:
                raise ValueError(f"{self.heads} heads over a model axis "
                                 f"of {tp.size}")
            self.local_heads = self.heads // tp.size
            self.tp = tp

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        """``x`` ``[N, L, D]`` over an ``hw`` grid of ``L`` tokens."""
        n, l, _ = x.shape
        h, hd = self.local_heads, self.head_dim

        def proj(layer):
            return layer(x).reshape(n, l, h, hd).transpose(1, 2)

        q, k, v = proj(self.query), proj(self.key), proj(self.value)
        with span(self.span_name):
            # f32 logits from the dtype's q and k (a bf16 product is exact
            # in f32), scaled after the product, in place: a global block's
            # logits are [N, heads, L, L].
            qf = q.float()
            logits = torch.matmul(qf, k.float().transpose(-1, -2))
            logits.mul_(self.scale)
            if self.rel_pos:
                self._add_rel_pos(logits, qf, hw)
            attn = torch.softmax(logits, dim=-1).to(self.dtype)
            out = torch.matmul(attn, v).to(self.dtype)
        return self.out(out.transpose(1, 2).reshape(n, l, h * hd))

    def _add_rel_pos(self, logits: torch.Tensor, qf: torch.Tensor,
                     hw: Tuple[int, int]) -> None:
        """``logits`` ``[N, h, L, L]`` += ``rel_h[.., kh] + rel_w[.., kw]``
        in place on their ``[N, h, qh, qw, kh, kw]`` view, from the
        unscaled f32 ``qf``."""
        gh, gw = hw
        tables = (self.rel_pos_h, self.rel_pos_w)
        if self.tp is not None:
            tables = tuple(self.tp.copy(t) for t in tables)
        r_q = qf.reshape(qf.shape[0], qf.shape[1], gh, gw, qf.shape[-1])
        rel_h = torch.einsum("nhyxc,ykc->nhyxk", r_q,
                             get_rel_pos(gh, gh, tables[0]))
        rel_w = torch.einsum("nhyxc,xkc->nhyxk", r_q,
                             get_rel_pos(gw, gw, tables[1]))
        grid = logits.view(logits.shape[:2] + (gh, gw, gh, gw))
        grid.add_(rel_h[..., None]).add_(rel_w[..., None, :])


def _window_partition(x: torch.Tensor, w: int
                      ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``[B, H, W, D]`` -> (``[B * nH * nW, w * w, D]``, padded (H, W)):
    zeros pad H and W to multiples of ``w``."""
    b, h, wd, d = x.shape
    ph, pw = (-h) % w, (-wd) % w
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, wd + pw
    x = x.reshape(b, hp // w, w, wp // w, w, d)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, d)
    return x, (hp, wp)


def _window_unpartition(x: torch.Tensor, w: int, hw_pad: Tuple[int, int],
                        hw: Tuple[int, int], batch: int) -> torch.Tensor:
    hp, wp = hw_pad
    d = x.shape[-1]
    x = x.reshape(batch, hp // w, wp // w, w, w, d)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(batch, hp, wp, d)
    return x[:, :hw[0], :hw[1], :]


class Block(nn.Module):
    """Pre-LN transformer block over the NHWC token grid; ``window`` 0 is
    global attention. ``rel_pos`` is the side ``S`` of the attention's
    relative-position tables (0: none)."""

    def __init__(self, dim: int, heads: int, window: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32, device=None,
                 rel_pos: int = 0):
        super().__init__()
        self.window = window
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = Attention(dim, heads, dtype, device, rel_pos=rel_pos,
                              window=window)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp_fc1 = Dense(dim, mlp_ratio * dim, dtype=dtype, device=device)
        self.mlp_fc2 = Dense(mlp_ratio * dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, d = x.shape
        y = self.norm1(x).to(self.dtype)
        if self.window > 0:
            y, hw_pad = _window_partition(y, self.window)
            y = self.attn(y, (self.window, self.window))
            y = _window_unpartition(y, self.window, hw_pad, (h, w), b)
        else:
            y = self.attn(y.reshape(b, h * w, d), (h, w)).reshape(b, h, w, d)
        x = x + y
        y = self.norm2(x).to(self.dtype)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(y)))
        return x + y


def resize_pos_embed(pos: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``[1, g, g, D]`` -> ``[1, h, w, D]`` in f32: ``jax.image.resize``'s
    bilinear (half-pixel centres, edges clamped; a triangle filter widened
    by the scale when it shrinks, which is torch's antialiased bilinear)."""
    if tuple(pos.shape[1:3]) == tuple(hw):
        return pos.float()
    out = F.interpolate(pos.float().permute(0, 3, 1, 2), size=tuple(hw),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


class ViT(nn.Module):
    """Plain ViT backbone: ``{"plain": [B, H/16, W/16, dim]}`` in the block
    dtype. ``freeze_stem`` detaches the patch and position embeddings'
    sum, so neither gets a gradient; ``remat`` recomputes each block in the
    backward pass; ``rel_pos`` gives every block detectron2's decomposed
    relative positions (tables of side ``window`` in window blocks,
    ``pos_grid`` in global ones)."""

    def __init__(self, dim: int = 768, depth: int = 12, heads: int = 12,
                 patch: int = 16, window: int = 14,
                 global_attn_every: int = 3, pos_grid: int = 64,
                 dtype: torch.dtype = torch.float32,
                 freeze_stem: bool = False, device=None, remat: bool = False,
                 rel_pos: bool = False):
        super().__init__()
        self.patch = patch
        self.remat = remat
        self.dtype = dtype
        self.freeze_stem = freeze_stem
        self.dim = dim
        self.patch_embed = Conv(3, dim, patch, patch, dtype=dtype,
                                device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, pos_grid, pos_grid, dim, device=device))
        self.depth = depth
        for i in range(depth):
            is_global = (i + 1) % global_attn_every == 0
            self.add_module(f"block{i}", Block(
                dim, heads, 0 if is_global else window, dtype=dtype,
                device=device,
                rel_pos=(pos_grid if is_global else window) if rel_pos else 0))
        self.norm = LayerNorm(dim, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # Flax's truncated_normal(0.02): a standard normal cut at +-2,
        # times 0.02.
        draw = torch.empty(self.pos_embed.shape, dtype=torch.float32)
        nn.init.trunc_normal_(draw, 0.0, 0.02, -0.04, 0.04,
                              generator=generator)
        with torch.no_grad():
            self.pos_embed.copy_(draw)

    def forward(self, x: torch.Tensor,
                stop_at: str = "") -> Dict[str, torch.Tensor]:
        """NCHW (channels-last) image -> ``{"plain": NHWC tokens}``.
        ``stop_at`` is the conv backbones' argument and is ignored."""
        del stop_at
        h, w = x.shape[2:]
        if h % self.patch or w % self.patch:
            raise ValueError(
                f"ViT backbone needs canvas dims divisible by patch size "
                f"{self.patch}, got {(h, w)}")
        x = self.patch_embed(x.to(self.dtype)).permute(0, 2, 3, 1)
        pos = resize_pos_embed(self.pos_embed, x.shape[1:3])
        x = x + pos.to(self.dtype)
        if self.freeze_stem:
            x = x.detach()
        for i in range(self.depth):
            x = run_block(getattr(self, f"block{i}"), x, self.remat)
        return {"plain": self.norm(x).to(self.dtype)}


class SimpleFeaturePyramid(nn.Module):
    """p2..p6 of ``channels`` from the plain stride-16 map (see the module
    docstring)."""

    LEVELS = ("p2", "p3", "p4", "p5")

    def __init__(self, dim: int, channels: int = 256,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.channels = channels
        self.dtype = dtype
        self.up4_deconv1 = ConvTranspose(dim, dim // 2, 2, dtype=dtype,
                                         device=device, lecun_init=True)
        self.up4_ln = LayerNorm(dim // 2, device=device)
        self.up4_deconv2 = ConvTranspose(dim // 2, dim // 4, 2, dtype=dtype,
                                         device=device, lecun_init=True)
        self.up2_deconv = ConvTranspose(dim, dim // 2, 2, dtype=dtype,
                                        device=device, lecun_init=True)
        in_ch = {"p2": dim // 4, "p3": dim // 2, "p4": dim, "p5": dim}
        for name in self.LEVELS:
            self.add_module(f"{name}_proj", Conv(
                in_ch[name], channels, 1, bias=False, dtype=dtype,
                device=device))
            self.add_module(f"{name}_proj_ln", LayerNorm(channels,
                                                         device=device))
            self.add_module(f"{name}_out", Conv(
                channels, channels, 3, bias=False, dtype=dtype,
                device=device))
            self.add_module(f"{name}_out_ln", LayerNorm(channels,
                                                        device=device))

    def _ln(self, name: str, y: torch.Tensor) -> torch.Tensor:
        """LayerNorm over the channels of an NCHW map; the result is
        channels-last in memory, in the pyramid's dtype."""
        return getattr(self, name)(y.permute(0, 2, 3, 1)).to(
            self.dtype).permute(0, 3, 1, 2)

    def forward(self, feats: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """``{"plain": [B, h, w, D]}`` -> ``{"p2".."p6"}``."""
        x = feats["plain"].permute(0, 3, 1, 2)  # NCHW, channels-last
        up2 = self.up4_deconv1(x)
        scaled = {
            "p2": self.up4_deconv2(F.gelu(self._ln("up4_ln", up2))),
            "p3": self.up2_deconv(x),
            "p4": x,
            # Flax's SAME 2x2 stride-2 pool: ceil cells, the edge padded
            # with -inf (VALID on the presets' even grids).
            "p5": F.max_pool2d(x, 2, 2, ceil_mode=True),
        }
        outs = {}
        for name, y in scaled.items():
            y = self._ln(f"{name}_proj_ln", getattr(self, f"{name}_proj")(y))
            outs[name] = self._ln(f"{name}_out_ln",
                                  getattr(self, f"{name}_out")(y))
        outs["p6"] = outs["p5"][:, :, ::2, ::2]
        return outs


def build_vit(name: str, cfg, dtype: torch.dtype, device=None) -> ViT:
    """The ViT of ``name`` in ``VIT_VARIANTS``; ``cfg`` is the
    ``BackboneConfig`` (its ``vit_*`` fields, ``freeze_stem`` and
    ``remat``)."""
    dim, depth, heads = VIT_VARIANTS[name]
    return ViT(dim=dim, depth=depth, heads=heads, window=cfg.vit_window,
               global_attn_every=cfg.vit_global_attn_every,
               pos_grid=cfg.vit_pos_grid, dtype=dtype,
               freeze_stem=cfg.freeze_stem, device=device, remat=cfg.remat,
               rel_pos=cfg.vit_rel_pos)
