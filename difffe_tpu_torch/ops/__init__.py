"""Numerical operators of the PyTorch port: assembly, differentiable
solves, CG, the tridiagonal PCR solver and the mixed-precision solves (the
names ``difffe_tpu.ops`` exports)."""

from .assembly import (
    assemble_load,
    assemble_lumped_mass,
    assemble_stiffness_dense,
    assemble_tridiag_1d,
    element_apply as element_apply_2d,
    kappa_on_elements,
    local_stiffness_2d,
    stiffness_apply,
)
from .cg import solve_poisson_cg, stiffness_diag
from .precision import (
    refine,
    solve_poisson_structured_bf16,
    tridiag_solve_refined,
)
from .solve import (
    apply_dirichlet_dense,
    apply_dirichlet_operator,
    cholesky_solve,
    dirichlet_rhs,
    lu_solve,
    solve_dense,
)
from .tridiag import solve_poisson_tridiag, tridiag_matvec, tridiag_solve

__all__ = [
    "assemble_load",
    "assemble_lumped_mass",
    "assemble_stiffness_dense",
    "assemble_tridiag_1d",
    "element_apply_2d",
    "kappa_on_elements",
    "local_stiffness_2d",
    "stiffness_apply",
    "solve_poisson_cg",
    "stiffness_diag",
    "refine",
    "solve_poisson_structured_bf16",
    "tridiag_solve_refined",
    "apply_dirichlet_dense",
    "apply_dirichlet_operator",
    "cholesky_solve",
    "dirichlet_rhs",
    "lu_solve",
    "solve_dense",
    "solve_poisson_tridiag",
    "tridiag_matvec",
    "tridiag_solve",
]
