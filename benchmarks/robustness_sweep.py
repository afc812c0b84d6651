"""Robustness sweep of the HEADLINE solver options across model families
(VERDICT r2 weak #6 / next #7): closed-loop MPC at bench.py's exact
solver configuration on representative cells of each benchmark family,
asserting 0 bad statuses and max KKT <= 1e-8 per cell.

Usage: python -m benchmarks.robustness_sweep [out.jsonl]
Runs on any backend.
"""

import json
import os
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

CELLS = (
    ("crane", dict(md=2, Nr=2, Nh=10)),
    ("crane", dict(md=3, Nr=3, Nh=12)),
    ("linear_chain", dict(nm=2, nu_count=1, md=3, Nr=2, Nh=12)),
    ("linear_chain", dict(nm=4, nu_count=3, md=2, Nr=2, Nh=10)),
    ("quadcopter", dict(md=2, Nr=2, Nh=10)),
    ("quadcopter", dict(md=3, Nr=2, Nh=12)),
    ("spring_mass", dict(nm=2, md=3, Nr=2, Nh=12)),
)
NSIM = 12


def main(out_path="benchmarks/results/bench_opts_robustness.jsonl"):
    import numpy as np

    import bench
    from benchmarks import models
    from benchmarks.closed_loop import closed_loop_mpc

    opts = bench.bench_opts()  # the headline configuration, verbatim
    rows = []
    for family, cell in CELLS:
        if family == "spring_mass":
            qp, _ = models.spring_mass_chain(**cell)
            import dataclasses as _dc

            @_dc.dataclass
            class _M:
                qp: object
                x0: object

                def simulate(self, x, u):
                    import jax.numpy as jnp
                    A = self.qp.A[1]
                    B = self.qp.B[1]
                    nx, nu = A.shape[0], B.shape[1]
                    return A @ x[:nx] + B @ u[:nu] + self.qp.b[1]
            model = _M(qp=qp, x0=np.asarray(qp.xmin[0, : qp.topo.nx[0]]))
        else:
            model = getattr(models, family)(**cell)
        log = closed_loop_mpc(model, "tdunes", nsim=NSIM, opts=opts,
                              kkt_tol=1e-8)
        row = dict(family=family, **cell,
                   kkt_max=float(np.max(log.kkt)),
                   viol=int(np.sum(log.kkt > 1e-8)),
                   status_bad=int(np.sum(log.status != 0)),
                   mean_iters=float(np.mean(log.iters)))
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    bad = [r for r in rows if r["status_bad"] or r["kkt_max"] > 1e-8]
    print(json.dumps({"summary": "bench_opts_robustness",
                      "cells": len(rows), "bad_cells": len(bad)}))


if __name__ == "__main__":
    main(*sys.argv[1:])
