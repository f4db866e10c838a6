"""Generic MILP solver: dense-simplex LP relaxation + best-first
branch-and-bound. Replaces Gurobi (unavailable offline). Small and exact —
the DiffServe allocation problems have a handful of variables, so this
solves in well under a millisecond (§4.5 reports ~10 ms for Gurobi).

    minimize    c·x
    subject to  A_ub x <= b_ub,  0 <= x <= upper,  x_i integer for i∈integer

PyTorch-port copy of ``repro/core/bnb.py`` (framework-free; imports
rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class MILP:
    c: np.ndarray
    A_ub: np.ndarray
    b_ub: np.ndarray
    integer: Sequence[int] = ()
    upper: Optional[np.ndarray] = None
    lower: Optional[np.ndarray] = None


@dataclasses.dataclass
class Solution:
    status: str                # optimal | infeasible
    x: Optional[np.ndarray] = None
    objective: float = math.inf


# ---------------------------------------------------------------------------
# LP via big-M primal simplex on the standard form with slacks
# ---------------------------------------------------------------------------
def _solve_lp(c, A, b, lower, upper, tol=1e-9, max_iter=2000):
    """min c·x  s.t.  A x <= b,  lower <= x <= upper  (dense, small).

    Shifts x by `lower`, folds upper bounds in as extra rows, then runs
    Big-M simplex with slack basis. Returns (status, x, obj)."""
    n = len(c)
    shift = lower
    b2 = b - A @ shift
    rows = [A]
    rhs = [b2]
    ub = upper - lower
    finite = np.isfinite(ub)
    if finite.any():
        eye = np.eye(n)[finite]
        rows.append(eye)
        rhs.append(ub[finite])
    A2 = np.vstack(rows)
    b3 = np.concatenate(rhs)
    m = len(b3)

    # make rhs nonnegative; rows with negative rhs need artificial vars
    neg = b3 < -tol
    A2[neg] *= -1.0
    b3[neg] *= -1.0
    # after flipping, "<=" rows that were flipped become ">=": slack -1 + art
    n_art = int(neg.sum())
    T = np.zeros((m, n + m + n_art))
    T[:, :n] = A2
    slack_sign = np.where(neg, -1.0, 1.0)
    T[np.arange(m), n + np.arange(m)] = slack_sign
    art_cols = []
    k = 0
    for i in range(m):
        if neg[i]:
            T[i, n + m + k] = 1.0
            art_cols.append(n + m + k)
            k += 1
    big_m = 1e7 * (1 + float(np.abs(c).max()) if len(c) else 1.0)
    cost = np.concatenate([c, np.zeros(m), np.full(n_art, big_m)])

    basis = []
    k = 0
    for i in range(m):
        if neg[i]:
            basis.append(art_cols[k])
            k += 1
        else:
            basis.append(n + i)
    basis = np.array(basis)

    for _ in range(max_iter):
        B = T[:, basis]
        try:
            Binv = np.linalg.inv(B)
        except np.linalg.LinAlgError:
            return "infeasible", None, math.inf
        xb = Binv @ b3
        lam = cost[basis] @ Binv
        reduced = cost - lam @ T
        j = int(np.argmin(reduced))
        if reduced[j] >= -tol:
            x_full = np.zeros(T.shape[1])
            x_full[basis] = xb
            if n_art and x_full[art_cols].sum() > 1e-5:
                return "infeasible", None, math.inf
            x = x_full[:n] + shift
            return "optimal", x, float(c @ x)
        d = Binv @ T[:, j]
        mask = d > tol
        if not mask.any():
            return "unbounded", None, -math.inf
        ratios = np.where(mask, xb / np.where(mask, d, 1.0), math.inf)
        i = int(np.argmin(ratios))
        basis[i] = j
    return "infeasible", None, math.inf


def solve_milp(p: MILP, max_nodes: int = 10_000,
               incumbent: Optional[np.ndarray] = None) -> Solution:
    """``incumbent``: optional known-feasible point (integer-rounded and
    bound-checked here) whose objective seeds the branch-and-bound upper
    bound, so pruning starts at the root instead of after the first
    integral leaf — decisive for objectives whose LP relaxation is very
    fractional (e.g. non-uniform cost weights)."""
    n = len(p.c)
    lower0 = np.zeros(n) if p.lower is None else np.asarray(p.lower, float)
    upper0 = (np.full(n, np.inf) if p.upper is None
              else np.asarray(p.upper, float))
    int_set = list(p.integer)

    best = Solution("infeasible")
    if incumbent is not None:
        xi = np.asarray(incumbent, float).copy()
        for i in int_set:
            xi[i] = round(xi[i])
        if ((p.A_ub @ xi <= p.b_ub + 1e-6).all()
                and (xi >= lower0 - 1e-9).all()
                and (xi <= upper0 + 1e-9).all()):
            best = Solution("optimal", xi, float(p.c @ xi))

    # objective-lattice pruning: when every variable is integer and every
    # objective coefficient is (numerically) an integer, all attainable
    # objectives sit on the integer lattice — a node can only beat the
    # incumbent by >= 1, so prune anything within 1-eps of it. This never
    # changes the returned optimum (pruned subtrees hold no strictly
    # better point), it only skips proving ties node by node.
    prune_eps = 1e-9
    if (len(int_set) == n and n
            and np.all(np.abs(p.c - np.round(p.c)) < 1e-9)):
        prune_eps = 1.0 - 1e-6
    heap = []
    counter = itertools.count()
    status, x, obj = _solve_lp(p.c, p.A_ub, p.b_ub, lower0, upper0)
    if status != "optimal":
        # the incumbent was bound- and constraint-checked above, so the
        # problem is feasible: the root LP died on the iteration limit —
        # return the known-feasible point instead of claiming infeasible
        return best if best.status == "optimal" else Solution(status)
    heapq.heappush(heap, (obj, next(counter), lower0, upper0, x))

    nodes = 0
    while heap and nodes < max_nodes:
        bound, _, lo, hi, x = heapq.heappop(heap)
        if bound >= best.objective - prune_eps:
            continue
        nodes += 1
        frac_i = None
        for i in int_set:
            if abs(x[i] - round(x[i])) > 1e-6:
                frac_i = i
                break
        if frac_i is None:
            xi = x.copy()
            for i in int_set:
                xi[i] = round(xi[i])
            obj = float(p.c @ xi)
            if obj < best.objective:
                best = Solution("optimal", xi, obj)
            continue
        f = x[frac_i]
        for lo2, hi2 in (
                (lo, _set(hi, frac_i, math.floor(f))),
                (_set(lo, frac_i, math.ceil(f)), hi)):
            if lo2[frac_i] > hi2[frac_i]:
                continue
            status, x2, obj2 = _solve_lp(p.c, p.A_ub, p.b_ub, lo2, hi2)
            if status == "optimal" and obj2 < best.objective - prune_eps:
                heapq.heappush(heap, (obj2, next(counter), lo2, hi2, x2))
    return best


def _set(arr, i, v):
    out = arr.copy()
    out[i] = float(v)
    return out
