"""treeqp_tpu — a tree-sparse QP solver framework for accelerators.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of treeQP
(dual Newton on the tree formulation, dual Newton on scenario decomposition,
and a tree-structured primal-dual interior-point method), built around
level-synchronous batched tree linear algebra instead of per-node BLAS calls.

Double precision is the correctness path of a QP solver (the reference's
unit tests require 1e-12 KKT residuals, examples/random_qp.c:249); we enable
x64 at import. Solvers accept a dtype argument for the mixed-precision
path.
"""

import jax

jax.config.update("jax_enable_x64", True)
# On the H100, f32 matmuls may default to TF32 inputs (10-bit mantissa) —
# catastrophic for factorization accuracy. A QP solver must use true f32/f64
# matmul precision everywhere.
jax.config.update("jax_default_matmul_precision", "highest")

from treeqp_tpu.utils.tree import TreeStructure, number_of_nodes_multistage  # noqa: E402
from treeqp_tpu.core.qp_data import TreeQPIn, TreeQPOut, TREEQP_INF  # noqa: E402
from treeqp_tpu.core.kkt import kkt_residuals, max_kkt_residual  # noqa: E402
from treeqp_tpu.core.json_io import load_tree_qp_file, load_tree_qp_json  # noqa: E402
from treeqp_tpu.solvers.tdunes import TdunesOpts, tdunes_solve  # noqa: E402
from treeqp_tpu.solvers.ipm import IpmOpts, ipm_solve  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "TreeStructure",
    "number_of_nodes_multistage",
    "TreeQPIn",
    "TreeQPOut",
    "TREEQP_INF",
    "kkt_residuals",
    "max_kkt_residual",
    "load_tree_qp_file",
    "load_tree_qp_json",
    "TdunesOpts",
    "tdunes_solve",
    "IpmOpts",
    "ipm_solve",
]
