"""legionsolvers_tpu_torch: the PyTorch + CUDA port of legionsolvers_tpu.

Same module paths and public names as the JAX package, on torch tensors
that live on the card unless the caller asks for the CPU.  Ported so far:
the single-device solvers (CG, BiCGStab, GMRES, PCG with Jacobi) on 2-D
and 3-D stencils and on explicit matrices, i.e. deferred scalars, vectors,
COO/CSR/ELL operators, the planner (with compensated dots and the DIA, RCM
and routed-gather upgrades of explicit matrices), the matrix-free stencil
operator, the DIA, windowed-ELL and general-sparsity operators, whose
passes are hand-written CUDA kernels for Hopper (``ops/cuda/``,
``csrc/``), the systems of ``entry.py`` and the benchmark CLI
(``benchmark.py``) with its timing, traffic and op-rate roofline
(``utils/``).  Not ported yet: block systems and sharding.  The package imports torch, numpy and
scipy, never jax.
"""

from .options import DEFAULT_OPTIONS, SolverOptions, resolve_device
from .core.scalar import Scalar, ScalarHistory, alpha_from_scalars
from .core.partition import BlockPartition
from .core.vector import PartitionedVector
from .core.matrix import (
    AbstractLinearOperator,
    AbstractMatrix,
    COOMatrix,
    CSRMatrix,
)
from .parallel.dia_op import DiaOperator
from .parallel.distmatrix import RowPartitionedMatrix
from .parallel.genspmv import GeneralSpmvOperator
from .parallel.reorder import ReorderedOperator
from .parallel.stencil_op import StencilOperator
from .parallel.winell_op import SlicedWinEllOperator, WinEllOperator
from .planner import SquarePlanner
from .solvers.bicgstab import BiCGStabSolver
from .solvers.cg import CGSolver
from .solvers.gmres import GMRESSolver
from .solvers.pcg import JacobiPreconditioner, PCGSolver
from .entry import build_explicit_system
from .problems.laplacian import (
    coo_negative_laplacian_1d,
    csr_negative_laplacian_1d,
    laplacian_1d_kernel_size,
)
from .problems.stencil import (
    calculate_stencil_size,
    create_coo_stencil_matrix,
    create_csr_stencil_matrix,
    laplacian_stencil,
    stencil_grid_ndim,
)

__version__ = "0.1.0"
