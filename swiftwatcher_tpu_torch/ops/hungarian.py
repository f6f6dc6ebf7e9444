"""Linear assignment (Jonker-Volgenant) in plain PyTorch.

Counterpart of swiftwatcher_tpu/ops/hungarian.py:solve_lap: the shortest
augmenting path LAP of scipy.optimize.linear_sum_assignment, row by row
in ascending order, in float32, with the JAX version's arithmetic and tie
rules, so that both return the same col4row:

  * the reduced cost of row i is (((min_val + cost[i, :]) - u[i]) - v);
  * the duals are updated in scipy's order (_lsap.c);
  * Dijkstra pops the FIRST column of least reduced cost, and the sink is
    the first popped column that no row holds.

A Python loop over rows and Dijkstra steps: the plain version of the
device tracker's LAP (csrc/track_scan.cu solves it inside the scan).
"""

from __future__ import annotations

from typing import Optional

import torch

_INF = float("inf")


def _augment_row(cost, u, v, row4col, col4row, cur_row: int) -> None:
    """Augment `cur_row` into the partial assignment (in place)."""
    N = cost.shape[0]
    SR = torch.zeros(N, dtype=torch.bool, device=cost.device)
    SC = torch.zeros(N, dtype=torch.bool, device=cost.device)
    shortest = torch.full((N,), _INF, dtype=torch.float32, device=cost.device)
    pred = torch.full((N,), cur_row, dtype=torch.int32, device=cost.device)
    min_val = torch.zeros((), dtype=torch.float32, device=cost.device)
    i = cur_row
    while True:
        SR[i] = True
        r = min_val + cost[i] - u[i] - v
        upd = ~SC & (r < shortest)
        pred = torch.where(upd, i, pred)
        shortest = torch.where(upd, r, shortest)
        masked = torch.where(SC, _INF, shortest)
        j = int(torch.argmin(masked))           # the first least column
        min_val = masked[j]
        SC[j] = True
        nxt = int(row4col[j])
        if nxt < 0:
            break                               # j, unassigned, is the sink
        i = nxt
    # dual updates (scipy _lsap.c order)
    u[cur_row] += min_val
    other = SR.clone()
    other[cur_row] = False
    short_at_row = shortest[col4row.clamp(0, N - 1).long()]
    u.copy_(torch.where(other, u + min_val - short_at_row, u))
    v.copy_(torch.where(SC, v - (min_val - shortest), v))
    # augment along the predecessor chain
    while True:
        i = int(pred[j])
        row4col[j] = i
        j_prev = int(col4row[i])
        col4row[i] = j
        j = j_prev
        if i == cur_row:
            break


def solve_lap(cost: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """col4row (N,) int32: the column assigned to each row of cost (N, N).

    skip: optional (N,) bool marking padding rows, whose diagonal is 0 and
    whose every other cell (and every other row's cell in their column) is
    large.  They are assigned their diagonal first and never augmented;
    the other rows see the state of the full solve (see the JAX version's
    docstring), so the result equals the full solve's."""
    cost = cost.to(torch.float32)
    N = cost.shape[0]
    dev = cost.device
    u = torch.zeros(N, dtype=torch.float32, device=dev)
    v = torch.zeros(N, dtype=torch.float32, device=dev)
    if skip is None:
        row4col = torch.full((N,), -1, dtype=torch.int32, device=dev)
        col4row = row4col.clone()
        order = range(N)
    else:
        skip = skip.to(device=dev, dtype=torch.bool)
        rows = torch.arange(N, dtype=torch.int32, device=dev)
        row4col = torch.where(skip, rows, -1).to(torch.int32)
        col4row = row4col.clone()
        order = (~skip).nonzero().flatten().tolist()
    for cur_row in order:
        _augment_row(cost, u, v, row4col, col4row, cur_row)
    return col4row
