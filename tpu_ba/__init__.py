"""tpu-ba — accelerator-native bundle adjustment, SfM, and pose-graph
optimization in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
``caomw/BundleAdjustmentMatlab`` (reference mounted at /root/reference; empty at
survey and build time — see SURVEY.md §0). The functional contract is the one in
SURVEY.md §1.2: reprojection residuals, analytic camera/point Jacobian blocks,
Levenberg–Marquardt over the sparse normal equations with Schur-complement
elimination of points, PCG on the reduced camera system, robust kernels,
radial-distortion intrinsics refinement, BAL problem support, an SfM frontend,
pose-graph refinement, and multi-device/multi-host sharded BA.

Everything on the compute path is jit-compatible and shape-static: batched
einsums, segment-sums for the block-sparse assembly, and ``lax.while_loop``
control flow (no host round-trips inside the optimizer).
"""

__version__ = "0.2.0"

import os as _os

import jax as _jax

# On GPUs with tensor cores, XLA may run f32 matmuls/einsums in TF32 (a
# 10-bit mantissa) unless the precision is "highest". Normal-equation
# assembly and the Schur/PCG solve are conditioning-limited, not
# matmul-FLOP-limited, and the f32 parity with the f64 goldens
# (data/goldens/) is stated at full f32 multiply precision.
# Override with TPU_BA_MATMUL_PRECISION=default|high|highest if needed.
_jax.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("TPU_BA_MATMUL_PRECISION", "highest"),
)

from tpu_ba.core import BAProblem, LMConfig, LMResult, make_problem  # noqa: F401
