"""Every weight of a configuration drawn from the seed, on the device.

A reference module lists its tensors as ``(name, shape, draw)`` with
``draw`` one of ``("normal", mean, std)``, ``("uniform", lo, hi)``,
``("const", value)`` or ``("values", tensor)``; the configuration file's
``draws`` replace the draw of the names that match its patterns. All normal
draws come from one ``torch.randn`` and all uniform ones from one
``torch.rand`` on a generator of the device, in f32 (the program keeps f32
parameters and casts them at each layer). The same tensors go to the
program and to the reference.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, List, Sequence, Tuple

import torch

Spec = List[Tuple[str, tuple, tuple]]


def apply_draws(spec: Spec, draws: Dict[str, Sequence]) -> Spec:
    """``spec`` with the draw of each name replaced by the first pattern of
    ``draws`` (in the file's order) that matches it."""
    out = []
    for name, shape, draw in spec:
        for pattern, new in draws.items():
            if fnmatch.fnmatchcase(name, pattern):
                draw = tuple(new)
                break
        out.append((name, tuple(shape), tuple(draw)))
    return out


def draw(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """``name -> f32 tensor`` on ``device``, the same for the same seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {kind: sum(_numel(s) for _, s, d in spec if d[0] == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, d in spec:
        n = _numel(shape)
        kind = d[0]
        if kind in pools:
            x = pools[kind][at[kind]:at[kind] + n].view(shape)
            at[kind] += n
            out[name] = (x * d[2] + d[1] if kind == "normal"
                         else x * (d[2] - d[1]) + d[1])
        elif kind == "const":
            out[name] = torch.full(shape, float(d[1]), device=device)
        elif kind == "values":
            out[name] = d[1].to(device=device, dtype=torch.float32).reshape(
                shape).clone()
        else:
            raise ValueError(f"{name}: unknown draw {d!r}")
    return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copy ``weights`` into ``module``'s parameters and buffers, which must
    have exactly these names and shapes."""
    state = module.state_dict()
    missing = sorted(set(state) - set(weights))
    extra = sorted(set(weights) - set(state))
    if missing or extra:
        raise ValueError(f"the program's tensors differ from the reference's:"
                         f" missing {missing[:5]}, extra {extra[:5]}")
    for name, value in weights.items():
        if tuple(state[name].shape) != tuple(value.shape):
            raise ValueError(f"{name}: program {tuple(state[name].shape)}, "
                             f"reference {tuple(value.shape)}")
    module.load_state_dict(weights, strict=True)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
