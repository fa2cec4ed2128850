"""difffe_tpu_torch — differentiable finite elements in PyTorch and CUDA.

The PyTorch port of ``difffe_tpu`` for NVIDIA Hopper cards.  Module paths
mirror the JAX package, which stays the reference each ported part is
checked against.  This package imports ``torch`` and never ``jax``.

Ported so far:

* slice A, per-element-κ inversion on 1D line meshes — ``FEMesh.line``,
  1D load and band assembly, the PCR tridiagonal oracle, the closed-form
  chain solves, the hand-written CUDA kernel K1 (closed-form grad step and
  SGD chain) and ``fit_kappa``'s 1D route;
* slice C items 12-13, κ-field inversion on 2D structured grids —
  ``FEMesh.rectangle``, the stencil operators (ops/stencil.py), the PCG
  body (ops/pcg.py), the hand-written CUDA whole-CG kernels K3a/K3b
  (ops/kernels/stencil_cg_kernel.py), the rectangle routes of
  ``solve_poisson[_batched]`` and ``fit_kappa``'s 2D route;
* slice D items 15-16, κ-field inversion on 3D boxes — ``FEMesh.box``,
  the 7-point stencil operators (ops/stencil3d.py), the hand-written CUDA
  whole-CG kernels K4a/K4b (ops/kernels/stencil3d_cg_kernel.py), the box
  routes of ``solve_poisson[_batched]`` and ``fit_kappa``'s 3D route;
* slice B's 1D facade and reference-parity surface — the hand-written
  CUDA PCR kernel K2 (ops/kernels/tridiag_kernel.py) behind
  ``method="tridiag_pallas"``, the dense Cholesky/LU solves
  (ops/solve.py), point Neumann/Robin terms, ``DifferentiableFESolver``,
  ``recover_kappa_scalar``, ``recover_kappa_field``, ``fit_kappa``'s
  generic Adam route, ``PhysicsLoss`` (losses.py) and ``NeuralPDE``
  (models/neural.py);
* slice G, the fused 1D grad-step kernels — K5a/K5b
  (ops/kernels/fused_grad_kernel.py), K6 (fused_grad_thomas_kernel.py)
  and K7 (fused_grad_mxu_kernel.py), hand-written CUDA — and the
  production κ-recovery loop on K7 (production.py);
* slice E, general meshes — the generic P1 triangle/tetrahedron
  assembly with tensor κ (ops/assembly.py), matrix-free CG with its
  implicit adjoint (ops/cg.py), edge Neumann/Robin terms, the edge-ELL
  gather operator and its solves (ops/unstructured.py: ``build_ell``,
  ``solve_poisson_cg_ell``, ``solve_poisson_cg_ell_batched``) with the
  hand-written CUDA kernels K8 (one operator application) and K8s (a
  whole fixed-trip solve) (ops/kernels/ell_kernel.py), the
  ``dense``/``lu``/``cg`` routes on any mesh, and ``fit_kappa``'s
  generic routes;
* the control and model layers — heat-equation rollouts (control/heat.py,
  on kernel K2 on the card), receding-horizon MPC and its batched planner
  (control/mpc.py), SIMP topology optimization (control/topopt.py), the
  DeepONet operator surrogate (models/operator.py) and mesh-free
  collocation training (models/collocation.py) — with the scenario
  configs, the metrics stream and the command line (utils/config.py,
  utils/metrics.py, cli.py);
* the parallel layer on ``torch.distributed`` (parallel/: the sharded
  κ-inversion step, the 2D and 3D halo-exchange solves, the
  time-pipelined rollout on K2, the expert bank, multi-process init),
  checkpointing, debug guards and profiling helpers (utils/), and the
  driver entry (entry.py).

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"`` in the mesh factories).
"""

from .mesh import FEMesh, default_dtype

__version__ = "0.1.0"

__all__ = [
    "FEMesh",
    "DifferentiableFESolver",
    "default_dtype",
    "solve_poisson",
    "solve_poisson_batched",
    "PhysicsLoss",
    "NeuralPDE",
    "recover_kappa_scalar",
    "recover_kappa_field",
    "solve_poisson_cf_batched",
    "fit_kappa",
    "train_collocation",
    "kappa_sgd_chain_cf",
    "StructuredGrid3",
    "solve_poisson_structured_3d",
    "solve_poisson_structured_3d_batched",
    "choose_3d_path",
    "choose_3d_grad_step",
    "build_ell",
    "solve_poisson_cg_ell",
    "solve_poisson_cg_ell_batched",
]

_STENCIL3D = ("StructuredGrid3", "solve_poisson_structured_3d",
              "solve_poisson_structured_3d_batched", "choose_3d_path",
              "choose_3d_grad_step")


def __getattr__(name):
    # Lazy imports keep `import difffe_tpu_torch` light.
    if name in ("solve_poisson", "solve_poisson_batched",
                "DifferentiableFESolver"):
        from . import solver
        return getattr(solver, name)
    if name == "PhysicsLoss":
        from .losses import PhysicsLoss
        return PhysicsLoss
    if name == "NeuralPDE":
        from .models.neural import NeuralPDE
        return NeuralPDE
    if name in ("recover_kappa_scalar", "recover_kappa_field"):
        from . import inverse
        return getattr(inverse, name)
    if name == "solve_poisson_cf_batched":
        from .ops.cf1d import solve_poisson_cf_batched
        return solve_poisson_cf_batched
    if name == "fit_kappa":
        from .inverse import fit_kappa
        return fit_kappa
    if name == "train_collocation":
        from .models.collocation import train_collocation
        return train_collocation
    if name in _STENCIL3D:
        from .ops import stencil3d
        return getattr(stencil3d, name)
    if name in ("build_ell", "solve_poisson_cg_ell",
                "solve_poisson_cg_ell_batched"):
        from .ops import unstructured
        return getattr(unstructured, name)
    if name == "kappa_sgd_chain_cf":
        from .ops.kernels.fused_grad_cf_kernel import kappa_sgd_chain_cf
        return kappa_sgd_chain_cf
    raise AttributeError(
        f"module 'difffe_tpu_torch' has no attribute {name!r}")
