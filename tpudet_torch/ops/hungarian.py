"""Exact linear-sum assignment (``tpudet.ops.hungarian``): the matcher of the
DETR family.

The same Jonker-Volgenant shortest-augmenting-path row step as the JAX
package (Crouse, "On implementing 2D rectangular assignment", IEEE TAES
2016), not scipy: every float operation in its order (``reduced = min_val +
cost[i] - u[i] - v`` in f32), first-index ``argmin``, rows solved in the
same order (all rows in order; under a mask the valid rows first, stably),
so the selected columns equal JAX's, ties included.

It runs on the host, in numpy, over a copy of the detached f32 cost, with
every problem of a batch (each decoder layer and image of a train step) in
lockstep, as JAX's ``vmap`` runs its while loops: one pass of a loop body
advances every problem that is still searching. On the card each of the
algorithm's short sequential steps would cost several launches and a sync
for the loop condition; on the host the whole matcher of a train step is a
few milliseconds. The copy to the host waits for the device.

Each call is a ``tpudet/matcher`` span (``utils.profiling.span``) with the
copies to the host in its child ``tpudet/matcher/fetch``: in a profiler's
trace the matcher's self time is the solve (and the copy of the answer back
to the device), the child's time the wait for the device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudet_torch.utils.profiling import span

__all__ = ["hungarian", "hungarian_masked"]


def _solve(cost: np.ndarray, order: np.ndarray,
           num_rows: np.ndarray) -> np.ndarray:
    """``cost [P, R, C]`` f32, ``order [P, R]`` the rows in solve order,
    ``num_rows [P]`` how many of them to solve -> ``col4row [P, R]`` (-1 for
    rows left unsolved)."""
    problems, rows, cols = cost.shape
    inf = np.float32(np.inf)
    u = np.zeros((problems, rows), np.float32)
    v = np.zeros((problems, cols), np.float32)
    col4row = np.full((problems, rows), -1, np.int64)
    row4col = np.full((problems, cols), -1, np.int64)
    for k in range(int(num_rows.max(initial=0))):
        act = np.nonzero(k < num_rows)[0]      # problems still assigning
        n = act.size
        ar = np.arange(n)
        cur = order[act, k]
        # Dijkstra from each problem's cur row over the alternating-path
        # graph: shortest[j] is the cheapest reduced-cost path to column j,
        # path[j] the row it enters j from.
        shortest = np.full((n, cols), inf, np.float32)
        path = np.full((n, cols), -1, np.int64)
        scanned_r = np.zeros((n, rows), bool)
        scanned_c = np.zeros((n, cols), bool)
        min_val = np.zeros(n, np.float32)
        i = cur.copy()
        sink = np.full(n, -1, np.int64)
        live = ar                              # searches without a sink yet
        while live.size:
            a, ii = act[live], i[live]
            scanned_r[live, ii] = True
            reduced = (min_val[live, None] + cost[a, ii]
                       - u[a, ii][:, None] - v[a])
            better = ~scanned_c[live] & (reduced < shortest[live])
            shortest[live] = np.where(better, reduced, shortest[live])
            path[live] = np.where(better, ii[:, None], path[live])
            masked = np.where(scanned_c[live], inf, shortest[live])
            j = masked.argmin(axis=1)          # the first of equal minima
            min_val[live] = masked[np.arange(live.size), j]
            scanned_c[live, j] = True
            owner = row4col[a, j]
            found = owner < 0
            sink[live[found]] = j[found]
            i[live[~found]] = owner[~found]
            live = live[~found]
        # Dual updates (keep reduced costs nonnegative).
        u[act, cur] += min_val
        other = scanned_r.copy()
        other[ar, cur] = False
        at = shortest[ar[:, None], np.clip(col4row[act], 0, cols - 1)]
        with np.errstate(invalid="ignore"):    # inf - inf where not taken
            u[act] = np.where(other, u[act] + min_val[:, None] - at, u[act])
            v[act] = np.where(scanned_c, v[act] - (min_val[:, None] - shortest),
                              v[act])
        # Augment: walk back from each sink, flipping the assignments.
        j = sink
        live = ar
        while live.size:
            a, jj = act[live], j[live]
            ii = path[live, jj]
            row4col[a, jj] = ii
            j[live] = col4row[a, ii]
            col4row[a, ii] = jj
            live = live[ii != cur[live]]
    return col4row


def _host_cost(cost: torch.Tensor) -> np.ndarray:
    rows, cols = cost.shape[-2:]
    if rows > cols:
        raise ValueError(
            f"hungarian needs rows <= cols (every row assigned a distinct "
            f"column); got [{rows}, {cols}]: transpose the cost")
    return cost.detach().to(torch.float32).cpu().numpy().reshape(-1, rows, cols)


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Minimize ``sum(cost[i, col4row[i]])`` over injective row -> column
    maps. ``cost [..., R, C]`` finite with ``R <= C`` -> ``col4row [..., R]``
    int64 on ``cost``'s device."""
    with span("tpudet/matcher"):
        with span("tpudet/matcher/fetch"):
            host = _host_cost(cost)
        problems, rows, _ = host.shape
        order = np.broadcast_to(np.arange(rows), (problems, rows))
        col4row = _solve(host, order, np.full(problems, rows))
        return torch.from_numpy(col4row.reshape(cost.shape[:-1])).to(
            cost.device)


def hungarian_masked(cost: torch.Tensor, row_valid: torch.Tensor
                     ) -> torch.Tensor:
    """``hungarian`` over the valid rows only (valid rows first, in a
    stable order), the set losses' matcher: ``cost [..., R, C]``,
    ``row_valid [..., R]`` -> ``col4row [..., R]`` int64, the out-of-bounds
    sentinel ``C`` for invalid rows."""
    with span("tpudet/matcher"):
        with span("tpudet/matcher/fetch"):
            host = _host_cost(cost)
            problems, rows, cols = host.shape
            valid = row_valid.detach().to(torch.bool).cpu().numpy().reshape(
                problems, rows)
        order = np.argsort(~valid, axis=1, kind="stable")
        col4row = _solve(host, order, valid.sum(axis=1))
        col4row = np.where(valid, col4row, cols)
        return torch.from_numpy(col4row.reshape(cost.shape[:-1])).to(
            cost.device)
