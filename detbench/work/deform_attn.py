"""The least time the multi-scale deformable attention kernels could take
on the card, from the shapes of one ``tpudet::ms_deform_attn_fwd`` or
``_bwd`` call, by the rules of the port's kernel table (``PERF.md`` rows 4a
and 4b) with every value row counted once:

* forward: the values, the locations and the weights read once and the
  f32 output written once; 24 f32 operations per sample (its position and
  four corner weights) and two per corner and channel (a multiply and an
  add), every corner of every sample counted;
* backward: the values read once and their gradient written once in their
  dtype, the locations, the weights and the f32 cotangent read once, the
  location and weight gradients written once; 56 operations per sample
  and four per corner and channel.

The bound is the larger of the bytes at the HBM rate and the operations at
the f32 rate outside the tensor cores."""

from __future__ import annotations

from math import prod

FWD_OPS_PER_SAMPLE = 24
FWD_OPS_PER_CORNER_CHANNEL = 2
BWD_OPS_PER_SAMPLE = 8 + 4 * 11 + 4
BWD_OPS_PER_CORNER_CHANNEL = 4
BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4}


def _parts(shapes, dtypes):
    values = [s for s in shapes if len(s) == 4][0]
    loc = [s for s in shapes if len(s) == 6][0]
    weights = [s for s in shapes if len(s) == 5][0]
    elt = BYTES.get(next(t for s, t in zip(shapes, dtypes) if len(s) == 4),
                    2)
    return values, loc, weights, elt


def forward_s(shapes, dtypes, peaks) -> float:
    values, loc, weights, elt = _parts(shapes, dtypes)
    b, q, h = loc[:3]
    d = values[-1]
    samples = prod(weights)
    moved = (prod(values) * elt + prod(loc) * 4 + samples * 4
             + b * q * h * d * 4)
    ops = (samples * FWD_OPS_PER_SAMPLE
           + 4 * samples * d * FWD_OPS_PER_CORNER_CHANNEL)
    return max(moved / peaks["hbm_bytes"], ops / peaks["f32_flops"])


def backward_s(shapes, dtypes, peaks) -> float:
    values, loc, weights, elt = _parts(shapes, dtypes)
    b, q, h = loc[:3]
    d = values[-1]
    samples = prod(weights)
    moved = (2 * prod(values) * elt + 2 * (prod(loc) + samples) * 4
             + b * q * h * d * 4)
    ops = (samples * BWD_OPS_PER_SAMPLE
           + 4 * samples * d * BWD_OPS_PER_CORNER_CHANNEL)
    return max(moved / peaks["hbm_bytes"], ops / peaks["f32_flops"])
