"""The ``tpudet::`` operator namespace: the Hopper kernels as
``torch.library`` operators.

Each kernel module registers its launchers here as operators with a CUDA
body (the ctypes launch of ``_build``'s library) and a fake body (the output
shapes and dtypes, no storage). ``torch.export`` traces a CUDA model through
the fake bodies and records the operators in the graph, so an exported
program carries the kernels; running it calls the CUDA bodies. Registering
builds and loads nothing: the library is built at the first CUDA call.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "tpudet"

_LIB = torch.library.Library(NAMESPACE, "DEF")


def register(name: str, schema: str, cuda: Callable, fake: Callable):
    """Define ``tpudet::<name><schema>`` with ``cuda`` as its CUDA body and
    ``fake`` as its fake body -> the operator's default overload."""
    _LIB.define(f"{name}{schema}")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def graph_ops(graph) -> list:
    """The ``tpudet::`` operators a ``torch.fx`` graph calls, by name, in
    the order of their first call."""
    names = []
    for node in graph.nodes:
        target = node.target
        if (node.op == "call_function"
                and getattr(target, "namespace", None) == NAMESPACE):
            name = target._schema.name.split("::")[1]
            if name not in names:
                names.append(name)
    return names
