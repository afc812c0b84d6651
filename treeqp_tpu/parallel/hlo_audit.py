"""HLO collective audit for the sharded solvers.

Compiles a sharded solve and extracts every cross-device collective
(all-gather / all-reduce / reduce-scatter / collective-permute /
all-to-all) from the optimized SPMD module, with its global byte count and
its JAX source region (the ``op_name`` metadata XLA carries through
GSPMD). This turns the analytic communication model in
``benchmarks/scaling_analysis.py`` — "each Newton iteration moves the
chain root contributions [S, nz] and the chain Schur complements
[S, nx, nx] plus scalar reductions, NOT whole chains" — from a prediction
into a compile-time-verified fact (VERDICT r3 #6):

* per-Newton-iteration collectives are the ones whose op_name lies under
  the solver's ``while/body`` source region;
* nesting under a second ``while/body`` (a per-level chain scan) means
  the collective fires L times per iteration — the audit weights those
  by the scan length, so a sharding regression that drags a collective
  into the chain sweeps (O(S L nx^2) traffic instead of O(S nx^2)) blows
  the byte budget immediately.

Reference scaling role: the OpenMP fork-join over scenarios in
dual_Newton_scenarios.c:528-563 / :332-345 shares memory; here the same
boundary data crosses the mesh axis, and this module pins down exactly
how much.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["CollectiveOp", "collect_collectives", "audit_compiled",
           "newton_iteration_bytes", "atomic_scatter_adds"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                "collective-permute", "all-to-all")

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8,
                "s32": 4, "u64": 8, "u32": 4, "s16": 2, "u16": 2,
                "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16}

# one result shape, e.g. "f32[8,16,16]{2,1,0}" (layout suffix optional)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\](?:\{[\d,]*\})?")


@dataclass(frozen=True)
class CollectiveOp:
    kind: str          # all-gather | all-reduce | ...
    shapes: tuple      # result shapes, e.g. ("f32[8,16,16]",)
    bytes_global: int  # total result bytes (unsharded view)
    op_name: str       # JAX source region from metadata
    weight: int        # executions per Newton iteration (scan-nesting)

    @property
    def weighted_bytes(self) -> int:
        return self.bytes_global * self.weight


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collect_collectives(hlo_text: str, body_tag: str = "/while/body/",
                        scan_weight: int = 1) -> list[CollectiveOp]:
    """Parse collectives out of optimized HLO module text.

    ``weight`` of each op = 1 if its op_name lies directly under the
    solver's Newton ``while/body`` region, ``scan_weight`` if it is nested
    under a second while (a per-level chain scan inside the iteration),
    and 0 for setup/teardown collectives outside the loop.
    """
    ops = []
    for line in hlo_text.splitlines():
        m = re.search(
            r"=\s*(.+?)\s+(" + "|".join(_COLLECTIVES) + r")\(", line)
        if not m:
            continue
        shape_text, kind = m.group(1), m.group(2)
        nm = re.search(r'op_name="([^"]*)"', line)
        op_name = nm.group(1) if nm else ""
        depth = op_name.count(body_tag)
        weight = 0 if depth == 0 else (1 if depth == 1 else scan_weight)
        ops.append(CollectiveOp(
            kind=kind,
            shapes=tuple(f"{d}[{s}]" for d, s in _SHAPE_RE.findall(shape_text)),
            bytes_global=_shape_bytes(shape_text),
            op_name=op_name, weight=weight))
    return ops


def newton_iteration_bytes(ops: list[CollectiveOp],
                           include_linesearch_batch: bool = False) -> int:
    """Weighted collective bytes per Newton iteration.

    The batched backtracking line search lives under a rejected-step-only
    cond branch (``cond/branch_1``); the common path (tau=1 accepted) is
    the per-iteration cost the scaling model counts.
    """
    total = 0
    for op in ops:
        if not include_linesearch_batch and "branch_1" in op.op_name:
            continue
        total += op.weighted_bytes
    return total


def audit_compiled(compiled, solver_name: str, scan_weight: int = 1) -> dict:
    """Audit a ``jax.jit(...).lower(...).compile()`` result.

    Returns summary stats: per-iteration collective bytes (common path),
    the largest single collective, and the op census.
    """
    txt = compiled.as_text()
    tag = f"jit({solver_name})/while/body/"
    ops = collect_collectives(txt, body_tag="/while/body/",
                              scan_weight=scan_weight)
    # keep only collectives attributed to this solver's regions
    ops = [o for o in ops if solver_name in o.op_name or not o.op_name]
    in_iter = [o for o in ops if o.weight > 0 and tag in o.op_name]
    per_iter = newton_iteration_bytes(in_iter)
    largest = max((o.bytes_global for o in ops), default=0)
    census: dict[str, int] = {}
    for o in ops:
        census[o.kind] = census.get(o.kind, 0) + 1
    return dict(ops=ops, in_iter=in_iter, per_iter_bytes=per_iter,
                largest_collective_bytes=largest, census=census)


def atomic_scatter_adds(stablehlo_text: str) -> list[str]:
    """Scatter-adds of a lowered module (``jax.jit(f).lower(...).as_text()``)
    that do not declare unique indices. On a GPU these run on atomics and
    add colliding updates in arrival order, so their results are not
    bitwise repeatable; every device of a sharded solve that computes the
    replicated crown with one can branch apart from the others."""
    lines = stablehlo_text.splitlines()
    found = []
    for i, line in enumerate(lines):
        if '"stablehlo.scatter"' not in line or "unique_indices = true" in line:
            continue
        # the combiner region follows on the next lines: ^bb0(...), op, return
        body = " ".join(lines[i + 1:i + 4])
        if "stablehlo.add" in body:
            found.append(line.strip())
    return found
