#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``difffe_tpu_torch``) on one CUDA card.

Drives the port's paths through their public entry points, in phases;
any failure raises, so the run exits non-zero and never prints the final
``ok`` line:

1. versions, the card's name and power limit (refuses to run without a
   card);
2. build the CUDA kernels from ``difffe_tpu_torch/csrc/``;

The 1D path (per-element κ on a line mesh, bench.py's workload: n = 30
elements, B = 2^21 scenarios, one shared forcing), kernel K1:

3. each K1 variant (step/chain × shared/f32/bf16 u_data) on the body of
   its row bucket (``k1_plan``: L lanes a scenario) against its plain
   PyTorch version, n ∈ {10, 30, 60, 100,
   128} (buckets 32, 32, 64, 128, 256), B ∈ {1000, 2^21} (1000 only at
   60 and 100): f32 within 1e-5 (step) and 1e-4 (32-step chain), and the
   plain version run in f64 by the rule of phase 7; padded lanes inert;
4. ``fit_kappa`` through the public entry point, 128 steps = 4 chain
   launches, with loss checks;
5. bench.py's parity gate: the step kernel's gradient against autograd
   through the PCR tridiagonal oracle on the bf16-quantized plane;
6. a ``torch.profiler`` split of one ``fit_kappa`` call; chained timing
   of the chain and its plain version, with the streamed bf16 u_data
   plane (K1d) and with shared u_data (K1c); the step's kernel time a
   call from the profiler, and its plain version's (K1b, K1a); the chain
   in the buckets 64, 128 and 256 (B = 2^18); the registers and spills of
   every K1 body.

The 2D path (κ-field inversion on ``FEMesh.rectangle(64, 64)``, the
structured-grid config of BASELINE.json, B = 4096 scenarios), kernels K3a
(whole-CG solve) and K3b (forward + MSE cotangent + adjoint CG):

7. K3a and K3b against their plain versions on the card at 8² (B = 7),
   64² (B = 4096) and 256² (B = 64), cold and warm, zero and nonzero
   Dirichlet values, each on the route its plan picks (one plan for both,
   printed with C and the bytes a block) and on the workspace route (the
   first design) forced, two launches equal bit for bit.  f32 CG amplifies
   summation-order differences, so the kernel is held against the plain
   version run in f64 on the card: its relative max error on x, λ and the
   κ gradient may be at most twice the f32 plain version's error against
   the same f64 run, plus 1e-6;
8. the main path: u_data from the fixed-trip batched solve (K3a),
   ``fit_kappa`` for 100 steps at lr = 300 (one K3b launch each; the
   converged misfit must fall below half the first step's), and the κ
   gradient of Σu² through the fixed-trip batched solve (K3a forward and
   adjoint) held against the plain version by the rule of phase 7; the
   3 K3a and 100 K3b launches all on the cluster route;
9. chained timing of K3b and K3a against their plain versions; each on its
   plan's route against the workspace route in turns, at every cluster
   size that fits, and at twice the iterations (one CG iteration's time);
   host time of ``fit_kappa`` and a ``torch.profiler`` split of one call.

The 3D path (κ-field inversion on ``FEMesh.box(32, 32, 32)``, B = 128
scenarios, the README's 32³ configuration at the κ-safe 100 iterations),
kernels K4a (whole-CG solve) and K4b (forward + MSE cotangent + adjoint CG):

10. K4a and K4b against their plain versions on the card at (nx, ny, nz) =
    (4, 4, 4) B = 5, (12, 9, 6) B = 7, 16³ B = 256, 32³ B = 128 and 48³
    B = 2, cold and warm, zero and nonzero Dirichlet values, and at 16³
    with bf16 coefficient storage, by the rule of phase 7; both on the
    route their plan picks (printed; 48³ takes the workspace route) and,
    where that is the cluster route, on the workspace route forced, two
    launches equal bit for bit;
11. the main path: u_data from the fixed-trip batched solve (one K4a
    launch), ``fit_kappa`` with its default policy (100 steps of one K4b
    launch, 100 cold iterations each, then one K4a eval launch) at
    lr = 1e7 (the converged misfit must fall below the first step's), and
    the κ gradient of Σu²
    through the fixed-trip batched solve (K4a forward and adjoint) held by
    the rule of phase 7, every launch on the cluster route;
12. chained timing of K4b and K4a against their plain versions; each on
    its plan's route against the workspace route (the first design) in
    turns, at every cluster size that fits, and at twice the iterations;
    host time of ``fit_kappa`` (at its default lr, whose misfit it logs)
    with and without its eval solve, and a ``torch.profiler`` split of one
    call.

The 1D facade path (BASELINE.json config 2: per-element κ recovery on
``FEMesh.line(128)``, 1024 κ/forcing scenarios, adjoint gradients), kernel
K2 (batched PCR tridiagonal solve, ``method="tridiag_pallas"``):

13. K2 against its plain version (the PCR oracle) on the card, n ∈ {1, 2,
    31, 129, 257, 4097}, B ∈ {1, 7, 1024, 65 536} (65 536 for n ≤ 257),
    f32 and f64, random diagonally dominant and Dirichlet-eliminated FEM
    bands, batched and shared bands, u and the three band gradients: f64
    within 1e-10 relative (at n = 4097 on FEM bands also a normwise
    backward error ≤ 1e-11), f32 by the rule of phase 7; on both routes
    where n ≤ 256 (``k2_plan``: the warp route, one warp a scenario; the
    block route, the first design) and on the block route above, each
    route's u and gradients equal to the plain version's bits; every
    layout and a second launch equal bit for bit;
14. the main path: u_data from ``solve_poisson_batched(method=
    "tridiag_pallas")``, ``recover_kappa_field`` for 200 Adam steps
    (1 + 2 × 200 K2 launches, all on the block route, which ``k2_plan``
    picks below 2048 systems; the misfit must fall 1e3×); then, in f64,
    ``recover_kappa_scalar`` (κ error < 1e-6), the three stages of
    examples/poisson_1d_demo.py (FEM error ≤ 1e-13, ``NeuralPDE`` within
    5% after 3000 epochs, κ = 2 within 1e-4) and
    ``DifferentiableFESolver(method="tridiag_pallas")`` against
    ``method="dense"`` (≤ 1e-10);
15. the κ gradient of the batched MSE through K2 forward and adjoint
    against the 'tridiag' route (f32 by the rule of phase 7, f64 ≤ 1e-10);
16. chained timing of K2 (forward, and forward + backward) at n = 129,
    B = 1024 (the main path's) and 65 536 against the plain version and
    ``torch.linalg.solve`` on the densified systems (at most B = 8192,
    scaled), and the device time of a call from the profiler, of the
    kernel on its two routes in turns, the plain version and
    ``torch.linalg.solve`` (the kernels line carries B = 1024's, where the
    chain is host-bound), the registers of both routes, host
    time of ``recover_kappa_field`` at B = 1024 and 65 536, and a
    ``torch.profiler`` split of one call.

The fused 1D grad-step path (examples/production_training_demo.py's
production κ-recovery loop: scalar κ per scenario on ``FEMesh.line(30)``,
B = 262 144, 300 SGD steps), kernels K5a/K5b (PCR with factor replay; its
warp route, one warp a scenario, for n ≤ 128, its block route, the first
design, above), K6 (Thomas; its reg route, a float32 scenario's rows in
registers, for n ≤ 32, its block route, the first design, otherwise)
and K7 (dense products with W = Ã⁻¹; its "tc" route on the tensor cores
for float32 and n ≤ 32, its "fma" route, the first design, otherwise):

17. each new kernel against its plain version on the card, n ∈ {2, 13,
    31, 129, 257} nodes for K5a/K5b/K6 and {2, 13, 31, 136} for K7 (137
    checks its route to K5a), B ∈ {7, 1000, 2^20} (2^20 for n ≤ 31, with
    K7's main-path storage, streamed f32 planes, among its cases),
    shared and streamed F, zero and nonzero Dirichlet values, f32 and bf16
    storage, K7 versions 1-3 with refine ∈ {0, 2, 3}, for n ≤ 32 on both
    routes (the "tc" route against the plain version with its products'
    rounding, 3xTF32 or bf16, two launches equal bit for bit, and each
    case's error against the exact f64 plain version printed), K5a/K5b
    for n ≤ 128 on both routes (``k5_plan(plan=)``), K5b's f32 and f64
    gradients equal bit for bit on the two, K6 for n ≤ 32 on both routes
    (``k6_plan(plan=)``), its f32 losses and gradients equal bit for bit
    on the two: f32 by the rule of phase 7 (bf16 products add 2^-8/n),
    f64 within 1e-10;
18. the main path: ``difffe_tpu_torch.production.sgd_loop`` at the demo's
    defaults (300 K7 launches, all on the "tc" route, and no other launch
    of the new kernels; the loss falls 10³×; the final κ and the mean
    loss of every step within 1e-3 relative of the same loop on the plain
    version);
19. the other workloads, each gated on its gradient against autograd
    through the 'tridiag' route on a B = 4096 slice fed the same
    quantized data (1e-4 in f32, 1e-2 with bf16 storage): bench_full.py's
    K7 row (B = 2^21, v3 refine 2, bf16 u_data, shared F), K7 versions 1,
    2 and 3 at refine 3 with f32 storage, and K5a row (B = 2^20, streamed
    F), and scripts/probe_thomas.py's per-element workload on K5b and K6
    (n = 30 elements, B = 2^21, shared F, f32 and bf16), K5 and K6 each
    on the route its plan picks (printed, its launch checked); K7 version
    3's
    gradient error at refine 0-3, f32 and bf16 storage, on the "tc"
    route (bf16 products) and on the plain version with one TF32 pass
    (the alternative kept in reserve, no kernel's) (printed);
20. chained timing of each new kernel at its phase 18/19 workload against
    its plain version; K5a and K5b on their two routes in turns, with the
    bound and each route's kernel time a call from the profiler, and that
    time at n = 31, 33, 64, 96 and 128 by batch (B = 7 … 65 536; a
    point no trace holds is printed as not measured); K6's two routes the
    same way at probe_thomas's workload, beside K5b's warp route, and by
    n = 2, 13, 31, 32, 33 and 64 and B = 7 … 2^21 (7 … 65 536 past
    n = 32, the block route alone); K7's two routes in
    turns at the production step
    and the bench row with each route's bound and the device time of a
    step from the profiler, each route's and the plain version's (the
    kernels line carries these: the production chain is host-bound on the
    "tc" route), the cuBLAS yardstick (two products X Wᵀ at (262 144, 31)
    × (31, 31), f32 and TF32, on the device and chained), host time of
    the phase-18 loop and of one K7 wrapper call, a ``torch.profiler``
    split of one loop, the registers and spills of the new kernels
    (K5's and K6's bodies among them) from the ``-Xptxas -v`` build log
    (a spill in K6's reg route fails the run), and the SASS instruction
    count of K6's float32 bodies (``cuobjdump -sass``).

The general-mesh path (κ-field inversion on a perturbed triangulation
without a grid, scripts/probe_unstructured.py's workload: 64 × 64 quads
split in two, interior nodes moved by U(±0.3h), 4225 nodes, 8192
triangles, B = 256 scenarios), kernels K8 (the masked edge-ELL operator,
the port of the TPU gather probe P1) and K8s (the whole fixed-trip ELL
solve in one launch, one thread-block cluster a scenario):

21. K8 against its plain version on the card: P1's own shapes (n = 256,
    8 indices a row, B = 8, unit weights, no diagonal, no mask) also
    against u[idx].sum(1), the 64² triangulation (6 neighbour slots) at
    B = 256, a perturbed 16³ box (14 slots) at B = 128 and a random
    Dirichlet mask at B = 7: f32 by the rule of phase 7, f64 within 1e-12,
    the body ``k8_body`` picks printed (the four-scenario "vec4" body
    where B % 4 == 0, else the scalar first design) and every body that
    takes the shape equal to it bit for bit;
    K8s (128 iterations, f32) against its plain version by the rule of
    phase 7 on a perturbed 8² triangulation at B = 7, the 64² one at
    B = 256 and the 16³ box at B = 128, at every cluster size that fits
    (the plan's choice printed), two launches equal bit for bit, a zero
    right-hand side giving 0;
22. the main path: u_data from the fixed-trip batched ELL solve (256
    iterations) of a load assembled in torch's deterministic mode (so
    a run's data repeat bit for bit), ``fit_kappa`` through the
    public entry point for 100 Adam steps at its defaults (iters 128, lr
    0.05): the path must be
    'generic_ell_batchminor', the loss finite and the converged misfit
    below half the first step's, and, in that call (the counts are set
    to 0 after the u_data solve, just before it), K8 launched 100 + 1
    times (each step's and the eval solve's right-hand side), all on the
    vec4 body, and K8s
    2 × 100 + 1 times (each step's forward and adjoint solves, the eval
    solve); the first step's loss and κ gradient (κ = 1) through
    ``solve_poisson_cg_ell_batched`` on K8s and on the per-iteration
    route (K8 an operator application), each held against the same solve
    on the plain version by the rule of phase 7 (the two routes' own
    difference printed); 10 steps on a perturbed 16³
    box at B = 128; and ``fit_kappa`` on line meshes the K1 kernel does
    not take (``FEMesh.line(300)`` in f32 and a float64 line), which must
    take the torch closed form with a falling loss and no K1 launch;
23. chained timing of K8's two bodies in turns against its plain
    version, with GB/s, its bound, each body's kernel time a call from
    the profiler with the L2 warm and after a read of twice the L2
    before each call (the time held against the bound), and
    ``torch.sparse.mm`` with the 0/1 adjacency in CSR (P1's unweighted
    function) at 64², B = 256 and on a
    perturbed 256² triangulation at B = 128 (66 049 nodes), and the
    bodies' registers; K8s at the same shapes and on the 16³ box
    at B = 128 on the plan's route
    against the per-iteration route in turns, at every cluster size that
    fits, at 0 iterations (the staging alone) and
    at twice the iterations, with its bound and its plain version's time;
    host time a step of ``fit_kappa`` on K8s (phase 22's call) and of a
    10-step call on the per-iteration route, and a ``torch.profiler``
    split of a 10-step call on K8s.

The K7 ablation path (the TPU probe P2, scripts/probe_mxu_kernel.py,
ported as ``difffe_tpu_torch/probes/k7_ablation.py``: K7 version 1 on
``FEMesh.line(30)``, B = 2^21, one shared load, bf16 u_data), variant A
= K7's first design (its "fma" route) and the kernels of
``csrc/k7_ablation.cu``: B (3xTF32 tensor-core products), C (bf16
tensor-core products), D (one product), E (no shifts), F
(register-blocked rows) and A1 (D and E's kernel with nothing ablated,
their baseline); and the tc set on K7's "tc" body (``csrc/tc_step.cuh``):
tcA (K7's "tc" route itself), tcB (one TF32 pass), tcC (one bf16 pass),
tcD (one product), tcE (no shifts) and tcF (two tiles a warp):

24. each variant against its plain version, n ∈ {13, 31}, B ∈ {1000,
    2^21}, zero and nonzero Dirichlet values, f32 and bf16 u_data: f32 by
    the rule of phase 7, f64 within 1e-10 for A, A1, D, E and F; F and A1
    equal to A (K7's "fma" route, forced) bit for bit (F pads 13 nodes to
    16 rows, 31 to 32); the tc set in f32 by the rule (single-pass
    products add one operand rounding, 2^-8/n for bf16, 2^-11/n for
    TF32), tcA and tcF equal to K7's "tc" route at version 1 bit for bit;
    then the probe's path: its staging, each variant's gradient on an
    8192-scenario slice against autograd through the PCR oracle on the
    same bf16-quantized data (A, A1, B, F, tcA and tcF within 1e-4; the
    others printed), and P2's timing (30 chained steps, best of 3) with
    121 launches of each variant (A's on K7's "fma" route, tcA's on its
    "tc" route) and no other (the kernels line carries these counts, read
    before the timing's calls), the tc set's kernel time a call from the
    profiler, tcA's and tcF's grids (blocks an SM) and registers from
    the profiler's kernel record at n = 31 and 13, and their kernel time
    at n = 13 (16 rows, where tcF does not spill); the plain versions'
    time, the cuBLAS product X Wᵀ at (2^21, 31) × (31, 31) in f32, TF32
    and bf16 as the products' yardstick, the registers of the new kernels
    and the SASS instruction count of the tc set's bodies.

The structured solver path (the generalized-mask natural-BC solves on
``FEMesh.rectangle(64, 64)``, B = 4096, and the plain-PyTorch solvers
around them: 2D and 3D multigrid, bf16 refinement, SPIKE), kernel K3a
on the natural route:

25. K3a against its plain version on natural planes (Dirichlet on the left
    edge only, a per-scenario Neumann flux on the right edge, an
    axis-adjacent Robin edge) and on custom-mask planes (the factory
    boundary with interior pins), 8² B = 7, 64² B = 4096, 256² B = 64,
    256 iterations, a forward and an adjoint-style solve, by the rule of
    phase 7, on the route its plan names (printed; launches counted by
    route), two launches equal bit for bit; the main path:
    ``solve_poisson_batched`` with those natural terms at full width
    (cg_tol = 0, cg_maxiter = 256) and the κ gradient of Σu² through it,
    2 K3a launches (forward and adjoint), every one on its plan's route
    and no other launch, u and the gradient by the rule of phase 7; the
    unbatched natural PCG route against the dense route in f64; the
    facade call chained, K3a alone on the natural planes against its
    plain version, and K3a's share of a forward + gradient call from a
    ``torch.profiler`` split;
26. 2D multigrid to 1e-10 at 64², 128² and 256² (W- and V-cycle
    iteration counts against the Jacobi-PCG of
    ``solve_poisson_structured``; the W-cycle's may grow at most 2.5×),
    ``solve_poisson_structured_bf16`` at 64², B = 4096, 48 inner
    iterations × (1 + 3) passes against the f64 oracle (per scenario:
    median ≤ 1e-3, worst ≤ 5e-3),
    ``tridiag_solve_spike`` against PCR at n = 4096, B = 4096 (f64 ≤ 1e-12,
    f32 ≤ 1e-5; both timed chained in turns) and
    ``tridiag_solve_refined`` at n = 30 (3 passes, ≤ 1e-5) and n = 128 (4
    passes, ≤ 5e-4) on tests/test_precision.py's problem against the f64
    oracle;
27. ``kappa_mse_grad_step_3d_mg`` at 48³, B = 128, f64, 120 iterations,
    against the converged Jacobi step (600 iterations; loss within 1e-9,
    κ gradient within 1e-6), the two steps in f32 chained in turns, and
    ``solve_poisson_structured_3d_mg`` at 64³ with its iteration count;
    phases 26-27 launch no kernel.

The control and model path (BASELINE.json config 3, heat-equation
receding-horizon source control: ``FEMesh.line(64)``, B = 4096 scenarios,
H = 50 steps, and config 5, topology optimization, 32²; the surrogates of
``models/``), kernel K2 on every rollout step:

28. the heat rollout's trajectory and the q-gradient of the tracking
    cost at config 3's width (f32, per-scenario κ in [0.8, 1.6], targets
    a_b·sin(πx) with a_b in [0.1, 0.4], the demo's three actuators) on
    the ``auto`` route, K2, against the 'tridiag' route by the rule of
    phase 7; the main path: ``make_planner_batched``, 60 Adam steps at
    lr 0.3, 6000 K2 launches (a forward and an adjoint step each), all on
    the warp route and no other launch, every scenario's last cost below
    0.3× its first; the plan's host time over chained calls, a
    device-only ``torch.profiler`` split (idle share, K2's share), K2's
    kernel time a call at (n = 65, B = 4096) against its bound, its plain
    version and ``torch.linalg.solve``; ``receding_horizon`` as
    examples/heat_mpc_demo.py runs it (20 MPC steps at B = 1: K2's block
    route, 20 × 6001 launches), its host time and tracking error (below
    half the first);
29. ``optimize_batched`` on config 5's ``topopt_2d`` (32², vol_frac 0.4,
    penal 3, 50 OC iterations, f32) at B = 16 and 1024 with forcings
    1 + a_b·sin(πx), a_b in [0, 0.5] from the seed: every scenario's
    compliance below 0.5× its first, the volume within 0.02 of 0.4, ρ in
    [0, 1], 25 bisection steps an OC step, no kernel launch; host time an
    OC iteration and the state solve's CG iterations at the first and the
    last ρ;
30. ``train_operator`` with tests/test_operator.py's gate arguments (loss
    < 1e-5, held-out relative error < 0.02) and, timed, at the JAX
    defaults on B = 4096 targets from ``FEMesh.line(128)`` (solved by one
    K2 launch), with inference at B = 4096; ``train_collocation`` with
    tests/test_collocation.py's gate arguments (max error < 0.02) and,
    timed, at its defaults on the unit square.

The parallel path (``difffe_tpu_torch/parallel/`` on ``torch.distributed``
at world size 1, the NCCL group of this one card: BASELINE.json config 2's
sharded κ inversion, config 4's halo solves, config 3's time pipeline),
kernel K2 on every 1D solve:

31. ``multihost.initialize()`` (NCCL, world size 1), ``HealthCheck.ping``
    over the mesh and the default group, ``timed_block_until_ready`` on 100
    chained K2 solves; ``make_inversion_step`` and
    ``make_inversion_step_shard_map`` on ``FEMesh.line(128)``, B = 1024,
    phase 14's data and per-element log κ, 200 Adam steps at lr 0.05 with
    ``method="tridiag_pallas"``: each run (its u_data solve and steps)
    1 + 2 × 200 K2 launches on the block route and no other, the misfit
    falling 10³×, the two variants' log κ and losses within 1e-6 and the
    losses within 1e-5 of ``recover_kappa_field``'s; ``entry()`` against
    the plain route, ``dryrun_multichip(1)``; a device profile of the
    200-step loop and K2's kernel time at its shape;
32. ``make_halo_solver`` on config 4's 64² grid, B = 64, 256 CG
    iterations a solve, 3 Adam steps of the κ-field inversion from κ = 1
    (the misfit must fall), the first loss and κ gradients within 1e-5 of
    ``solve_poisson_structured(dot=batched_dot(2))``, a device profile of
    a value and gradient; ``make_halo_solver_3d`` on a 32³ box, B = 128,
    100 iterations, one value and κ gradient within 1e-5 of
    ``solve_poisson_structured_3d(dot=batched_dot(3))``; no kernel launch;
33. ``pipelined_rollout`` at config 3 (``FEMesh.line(64)``, B = 4096,
    H = 50, Δt = 2e-3, 4 microbatches, depth 1): final state, cost and
    gradients to κ, u0 and f_seq against ``rollout_batched``, in f64 (K2
    in f64 against the plain route) within 1e-10 and in f32 within 1e-3
    (the κ gradient sums over microbatches and steps in another order),
    2 × 4 × 50 K2 launches on the block route and no other, a
    device profile and K2's kernel time at the microbatch's shape;
    ``moe_apply`` at B = 4096 over 8 experts of 64 × 3 tanh MLPs against a
    per-expert loop and with the mesh (1e-5); ``CheckpointManager``'s
    async round trip of phase 31's CUDA Adam state, bit for bit;
    ``golden_compare`` of the 1D solve on K2, f32 against f64, on
    tests/test_debug.py's problem with its bound (1e-4).

Each path's launch counts are set to 0 just before its main-path phases
(4-5, 8, 11, 14, 18, 22, 24's probe path, 25's facade call, 28's plan and
closed loop, each of 29's and 30's runs, each of 31's inversion runs,
32's halo runs, 33's pipeline and expert calls) and read just after; comparisons and timing outside those do not count.  The
third-to-last line is one JSON object describing each kernel, with its
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over 67 TFLOP/s (H100 SXM, fp32 outside the tensor cores;
tensor-core products at 495 TFLOP/s TF32 or 989 TFLOP/s bf16, float64 at
34 TFLOP/s).  The
second-to-last line is the card's name and power limit; the last line is
the ``ok`` JSON.

Run: ``python3 chip_smoke.py [--seed N]`` from the repository root (the
seed of the general-mesh path's node perturbation and data; default 0).
"""

import argparse
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

N_ELEMENTS = 30
BATCH = 2 ** 21
CHAIN_K = 32
STEPS = 128
LR = 30.0
BLOCK_LANES = 2048
STEP_TOL = 1e-5          # kernel vs plain, f32, single step
CHAIN_TOL = 1e-4         # kernel vs plain, f32, 32-step chain
GATE_TOL = 1e-4          # bench.py's gradient-parity gate
K1_NS = (10, 30, 60, 100, 128)   # phase 3: buckets NB 32, 32, 64, 128, 256
K1_BUCKET_NS = (60, 100, 128)    # phase 6: the chain in the other buckets
BATCH_BUCKETS = 2 ** 18
CU_SOURCE = "difffe_tpu_torch/csrc/fused_grad_cf.cu"
JAX_KERNEL = "difffe_tpu/ops/pallas/fused_grad_cf_kernel.py"

N_2D = 64                # config 4's grid, 64 × 64 quads
BATCH_2D = 4096
STEPS_2D = 100
K3A_ITERS = 256          # the u_data solve and K3a's timed workload
K3B_ITERS = 32           # fit_kappa's per-step iterations at 64²
GRAD_ITERS = 128         # the fixed-trip solve the κ gradient runs through
# fit_kappa's 2D default lr (30) lowers the 64² misfit only ~10% in 100
# steps, in the JAX reference as in the port (CPU runs at B = 2); ten times
# that halves it within the run, which the phase 8 gate asks
LR_2D = 300.0
K3_CASES = ((8, 7), (N_2D, BATCH_2D), (256, 64))   # phase 7: (n, B)
K3_SOURCE = "difffe_tpu_torch/csrc/stencil_cg.cu"
JAX_K3 = "difffe_tpu/ops/pallas/stencil_cg_kernel.py"

PEAK_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
L2_BYTES = 50 * 2 ** 20  # H100 SXM L2
PEAK_TF32 = 495e12       # H100 SXM tensor cores, dense
PEAK_BF16 = 989e12
PEAK_F64 = 34e12         # H100 SXM float64 outside the tensor cores
# K1 operations per element row per SGD step, counted from the three
# passes of cf_kernel in csrc/fused_grad_cf.cu (a division counts as one):
# 5 (S, T totals) + 21 (u, d, loss, P^λ, running sums) + 10 (gradient and
# the update)
K1_OPS_PER_ROW_STEP = 36
# K3 operations per node per CG iteration (stencil_cg_kernel.py:210):
# 5-point apply 9, two dots 4, x/r/p updates 6, Jacobi 1
K3_OPS_PER_NODE_ITER = 20

N_3D = 32                # the README's 32³ box
BATCH_3D = 128
STEPS_3D = 100           # fit_kappa's default
K4B_ITERS = 100          # fit_kappa's κ-safe default above 16 a side
K4A_ITERS = 400          # the u_data solve and K4a's timed workload
# fit_kappa's 3D default lr (100·B/256 = 50 here) hardly moves the 32³
# misfit in 100 steps (phase 12 logs it), so the gate that the misfit
# falls needs a larger step; 1e7 stays well inside κ_true's range
LR_3D = 1e7
# phase 10: (nx, ny, nz, B); the non-cubic grids catch a transposed axis
K4_CASES = ((4, 4, 4, 5), (12, 9, 6, 7), (16, 16, 16, 256),
            (N_3D, N_3D, N_3D, BATCH_3D), (48, 48, 48, 2))
K4_SOURCE = "difffe_tpu_torch/csrc/stencil3d_cg.cu"
JAX_K4 = "difffe_tpu/ops/pallas/stencil3d_cg_kernel.py"
# K4 operations per node per CG iteration (stencil3d_cg_kernel.py:159):
# 7-point apply 13, two dots 4, x/r/p updates 6, Jacobi 1
K4_OPS_PER_NODE_ITER = 24

N_1D = 128               # BASELINE.json config 2: 128 elements, 129 nodes
BATCH_1D = 1024          # its 1024 κ/forcing scenarios
STEPS_1D = 200           # Adam steps of recover_kappa_field
LR_1D = 0.05
K2_NS = (1, 2, 31, 129, 257, 4097)      # phase 13: system sizes
K2_BS = (1, 7, 1024, 65536)             # 65 536 only for n <= 257
BATCH_K2 = 65536         # phase 16: scripts/probe_tridiag.py's batch at n=129
K2_SWEEP_BS = (256, 2048, 4096, 8192, 16384)   # phase 16: K2's routes
BATCH_LIB = 8192         # torch.linalg.solve on the densified systems
K2_SOURCE = "difffe_tpu_torch/csrc/tridiag_pcr.cu"
JAX_K2 = "difffe_tpu/ops/pallas/tridiag_kernel.py"
# K2 operations per row and PCR sweep, counted from csrc/tridiag_pcr.cu:
# alpha, gamma (a negation and a division each) 4, a', c' 2, b', r' 8; one
# division per row after the last sweep
K2_OPS_PER_ROW_SWEEP = 14


N_NAT = 64               # phase 25's main path: config 4's 64² grid
BATCH_NAT = 4096
NAT_ITERS = 256          # the batched natural route's fixed trip (its cap)
NAT_CASES = ((8, 7), (N_NAT, BATCH_NAT), (256, 64))    # phase 25: (n, B)
MG_NS = (64, 128, 256)   # phase 26: 2D MG grids
BATCH_BF16 = 4096
BF16_INNER, BF16_PASSES = 48, 3
# ops/precision.py: 48 inner × (1 + 3) passes reach 5.1e-4 at 64² on one
# problem (JAX, CPU).  Per scenario, over phase 26's 4096 the median must
# meet 1e-3 and the worst 5e-3: the contraction varies with κ (the same
# problem on the CPU: median 4.2e-4, worst 2.8e-3 in 32 scenarios)
BF16_TOL_MEDIAN, BF16_TOL_MAX = 1e-3, 5e-3
N_SPIKE, BATCH_SPIKE, SPIKE_CHUNK = 4096, 4096, 64
SPIKE_F64_TOL = 1e-12
SPIKE_F32_TOL = 1e-5     # diagonally dominant bands: f32 PCR sits ~1e-7
# (n, passes, tolerance) of tests/test_precision.py's problem (κ = 1.37,
# one load): ops/precision.py measured 1.3e-6 at n = 30 in 3 passes and
# 1.8e-5 at n = 128 in 4 (JAX, CPU); n = 128 sits near the
# cond·ε_bf16 < 1 boundary, where the contraction is erratic from pass to
# pass
REFINED_CASES = ((30, 3, 1e-5), (128, 4, 5e-4))
N_MG3_STEP, BATCH_MG3 = 48, 128
# tests/test_multigrid3.py:159 holds 30 MG iterations to 600 Jacobi ones
# at 8³; at 48³ the step's cycle (pre = post = 1, 8 coarse sweeps) leaves
# the κ gradient 1e-2 off after 30, 1e-5 after 60, 4e-12 after 120
MG3_ITERS, JACOBI3_ITERS = 120, 600
N_MG3_SOLVE = 64

N_MPC = 64               # BASELINE.json config 3: FEMesh.line(64), 65 nodes
BATCH_MPC = 4096         # its 4096 scenarios
MPC_H, MPC_DT = 50, 2e-3             # its horizon; the demo's Δt
MPC_ITERS, MPC_LR, MPC_PENALTY = 60, 0.3, 1e-6   # the demo's planner
MPC_CENTERS, MPC_WIDTH = (0.25, 0.5, 0.75), 0.1  # the demo's actuators
MPC_RH_STEPS = 20        # examples/heat_mpc_demo.py's closed loop
# tests/test_control.py::test_planner_reduces_cost's bound (the CPU
# calibration with the JAX package gave 0.02-0.06 at this width, B = 4)
MPC_COST_RATIO = 0.3
N_TOPO, TOPO_ITERS = 32, 50          # config 5's topopt_2d
TOPO_BS = (16, 1024)
TOPO_RATIO = 0.5         # the CPU calibration: 0.32 after 50 iterations
OP_GATE = dict(width=48, depth=2, n_basis=24, n_epochs=4000, lr=2e-3)
N_OP_BIG, BATCH_OP_BIG = 128, 4096   # the defaults on config 2's line
COL_GATE = dict(hidden_dim=32, n_layers=2, n_points=64, n_epochs=1500,
                lr=3e-3, resample_every=250)


N_GEN = 64              # scripts/probe_unstructured.py's 64² triangulation
BATCH_GEN = 256
STEPS_GEN = 100
ELL_ITERS = 128          # fit_kappa's edge-ELL default
UDATA_ITERS = 256        # the u_data solve and the eval solve
N_GEN_BIG = 256          # phase 23's larger triangulation
BATCH_GEN_BIG = 128
N_BOX_GEN = 16           # phase 21/22's perturbed box
BATCH_BOX_GEN = 128
K8_SOURCE = "difffe_tpu_torch/csrc/ell_apply.cu"
P1_PROBE = "scripts/probe_mosaic_gather.py"
# K8 operations per output value and neighbour slot, counted from
# csrc/ell_apply.cu: p_j = 1 − m_j, p_j·v_j, the multiply-add (2); and per
# output value p_i, p_i·v_i, diag·(p_i v_i), m_i·v_i, p_i·acc and the sum
K8_OPS_PER_SLOT = 4
K8_OPS_PER_VALUE = 6
K8S_SOURCE = "difffe_tpu_torch/csrc/ell_cg.cu"
JAX_ELL_CG = "difffe_tpu/ops/unstructured.py"
# K8s operations, counted from csrc/ell_cg.cu and cg_cluster.cuh's loop: a
# nonzero slot of a node's apply 2 (product, sum); a node and iteration 13
# (diag·p and its sum 2, the two dots 4, the x, r and p updates 6, Jacobi 1)
K8S_OPS_PER_SLOT = 2
K8S_OPS_PER_NODE = 13


def log(*args):
    print(*args, flush=True)


def rel_err(a, b):
    """max|a − b| / max|b|; 0 where a equals b (two zero arrays too)."""
    if a.numel() == 0 and b.numel() == 0:
        return 0.0
    d = float((a - b).abs().max())
    return 0.0 if d == 0.0 else d / float(b.abs().max())


def bound(ops, nbytes, ops_s=None):
    """(bound_ms, bound_by) of a function doing ``ops`` operations that
    must move ``nbytes`` bytes; ``ops_s``, where given, is the operations'
    least time in seconds at their own rates (tensor-core products)."""
    t_ops = (ops / PEAK_FLOPS if ops_s is None else ops_s) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_entry(name, source, replaces, launches, max_abs, ms, plain_ms,
                 ops, nbytes, library_ms=None, ops_s=None):
    b_ms, b_by = bound(ops, nbytes, ops_s)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def timed_pair(kernel_fn, plain_fn, x0, length):
    """Best chained ms per call of each, timed plain, kernel, kernel,
    plain."""
    from difffe_tpu_torch.utils.profiling import timeit_chained

    best = {"kernel": float("inf"), "plain": float("inf")}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_fn if which == "kernel" else plain_fn
        t = timeit_chained(fn, x0, length=length, repeats=2)
        best[which] = min(best[which], t.min_s * 1e3)
    return best


def run_1d(torch, dev, card):
    """Phases 3-6; returns the K1 entries of the kernels line."""
    from difffe_tpu_torch import fit_kappa
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.assembly import assemble_load
    from difffe_tpu_torch.ops.cf1d import solve_poisson_cf_batched
    from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as tk
    from difffe_tpu_torch.solver import solve_poisson_batched

    def problem(n, B, seed):
        mesh = FEMesh.line(n, dtype=torch.float32, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        fv = torch.sin(torch.pi * mesh.nodes[:, 0]) + 1.0
        ke_true = 1.0 + 2.0 * torch.rand(B, n, generator=g, device=dev)
        with torch.no_grad():
            ud = solve_poisson_batched(mesh, ke_true, fv.expand(B, n + 1),
                                       method="tridiag")
        return mesh, fv, ud, g

    # -- phase 3: every K1 body against its plain version, f32 at the
    # tolerances and the f64 plain version by the rule of phase 7; n = 60
    # and 100 fill the buckets NB = 64 and 128 (10 and 30: 32; 128: 256)
    t0 = time.perf_counter()
    max_abs = {"step": 0.0, "chain": 0.0}
    for n in K1_NS:
        for B in ((1000, BATCH) if n in (10, 30, 128) else (1000,)):
            mesh, fv, ud, g = problem(n, B, seed=n + B)
            F = assemble_load(mesh, fv)
            ke0 = 1.0 + 0.3 * torch.rand(B, n, generator=g, device=dev)
            scale = 2.0 / (n + 1)
            L = tk.k1_plan(tk.packed_rows(n + 1))
            for mode in ("shared", "f32", "bf16"):
                keT, aux = tk.cf_packed_operands(
                    mesh, ke0, F, ud[0] if mode == "shared" else ud,
                    operand_dtype=torch.bfloat16 if mode == "bf16" else None)
                args = (aux["udT"], aux["cols"], B, scale, aux["u_l"],
                        aux["u_r"])
                args64 = (aux["udT"], aux["cols"].double(), B, scale,
                          aux["u_l"], aux["u_r"])
                lp_p, g_p = tk._cf_step_plain(keT, *args)
                lc_p, k_p = tk._cf_chain_plain(keT, *args, CHAIN_K, LR)
                lp_q, g_q = tk._cf_step_plain(keT.double(), *args64)
                lc_q, k_q = tk._cf_chain_plain(keT.double(), *args64,
                                               CHAIN_K, LR)
                lp_k, g_k = tk.kappa_mse_step_cf_packed(keT, aux, scale)
                lc_k, k_k = tk.kappa_sgd_chain_cf(keT, aux, CHAIN_K, LR,
                                                  scale)
                torch.cuda.synchronize()
                errs = {
                    "step_grad": rel_err(g_k[:, :B], g_p[:, :B]),
                    "step_loss": rel_err(lp_k[:, :B], lp_p[:, :B]),
                    "chain_kappa": rel_err(k_k[:, :B], k_p[:, :B]),
                    "chain_loss": rel_err(lc_k[:, :B], lc_p[:, :B]),
                }
                tag = f"phase 3 n={n} B={B} ud={mode} L={L}"
                rule = [check_rule(
                    "K1", a[:, :B], b[:, :B], c[:, :B], f"{tag} {what}")
                    for what, a, b, c in (
                        ("step_grad", g_k, g_p, g_q),
                        ("step_loss", lp_k, lp_p, lp_q),
                        ("chain_kappa", k_k, k_p, k_q),
                        ("chain_loss", lc_k, lc_p, lc_q))]
                log(f"{tag}: " + " ".join(
                    f"{k}={v:.2e}" for k, v in errs.items())
                    + "; vs f64 plain (kernel, f32 plain) " + " ".join(
                        f"({ek:.2e}, {ep:.2e})" for ek, ep in rule))
                if max(errs["step_grad"], errs["step_loss"]) > STEP_TOL:
                    raise AssertionError(f"{tag}: step kernel disagrees: "
                                         f"{errs}")
                if max(errs["chain_kappa"],
                       errs["chain_loss"]) > CHAIN_TOL:
                    raise AssertionError(f"{tag}: chain kernel "
                                         f"disagrees: {errs}")
                if not (torch.all(g_k[:, B:] == 0)
                        and torch.all(lp_k[:, B:] == 0)
                        and torch.all(lc_k[:, B:] == 0)
                        and torch.equal(k_k[:, B:], keT[:, B:])):
                    raise AssertionError(f"{tag}: padded lanes were "
                                         f"written")
                max_abs["step"] = max(max_abs["step"], float(
                    (g_k[:, :B] - g_p[:, :B]).abs().max()))
                max_abs["chain"] = max(max_abs["chain"], float(
                    (k_k[:, :B] - k_p[:, :B]).abs().max()))
                del keT, aux, lp_p, g_p, lc_p, k_p, lp_q, g_q, lc_q, k_q
                del lp_k, g_k, lc_k, k_k, args, args64
            del mesh, ud, ke0
            torch.cuda.empty_cache()
    log(f"phase 3 kernel vs plain: {time.perf_counter() - t0:.1f} s")

    # -- phases 4-5: the main path, with launch counts
    mesh, fv, u_data, _ = problem(N_ELEMENTS, BATCH, seed=0)
    n = mesh.n_nodes
    f = fv.expand(BATCH, n)
    loss_start = float(((solve_poisson_cf_batched(
        mesh, torch.ones(BATCH, N_ELEMENTS, device=dev), f) - u_data) ** 2
    ).mean())
    for k in tk.launches:
        tk.launches[k] = 0
    t0 = time.perf_counter()
    kappa, info = fit_kappa(mesh, f, u_data, steps=STEPS)
    torch.cuda.synchronize()
    hist = [float(v) for v in info["loss_history"]]
    log(f"phase 4 fit_kappa: path={info['path']} "
        f"launches={tk.launches['chain']} loss(kappa=1)={loss_start:.6e} "
        f"loss_history={hist} eval_loss={info['eval_loss']:.6e} "
        f"drop={loss_start / info['eval_loss']:.2f}x "
        f"({time.perf_counter() - t0:.2f} s)")
    if info["path"] != "cf_chain_kernel":
        raise AssertionError(f"fit_kappa took path {info['path']}")
    if tk.launches["chain"] != STEPS // CHAIN_K:
        raise AssertionError(f"chain launches {tk.launches['chain']}")
    if not bool(torch.isfinite(kappa).all()):
        raise AssertionError("fit_kappa returned non-finite kappa")
    if kappa.shape != (BATCH, N_ELEMENTS):
        raise AssertionError(f"kappa shape {tuple(kappa.shape)}")
    if not info["eval_loss"] * 10 <= loss_start:
        raise AssertionError("eval_loss is not 10x below the start loss")
    if not all(b < a for a, b in zip(hist, hist[1:])):
        raise AssertionError("loss_history does not fall at every launch")
    if not hist[0] >= 3 * hist[-1]:
        raise AssertionError("loss_history fell less than 3x")
    del kappa, info
    torch.cuda.empty_cache()

    # phase 5: bench.py's parity gate on the bf16 observation plane
    ke0 = torch.ones(BATCH, N_ELEMENTS, device=dev)
    keT0, aux = tk.cf_packed_operands(mesh, ke0, assemble_load(mesh, fv),
                                      u_data, block_lanes=BLOCK_LANES,
                                      operand_dtype=torch.bfloat16)
    scale = 2.0 / n
    _, gT = tk.kappa_mse_step_cf_packed(keT0, aux, scale=scale)
    ud_q = aux["udT"][:n, :BATCH].T.float()
    ke = ke0.clone().requires_grad_()
    u = solve_poisson_batched(mesh, ke, f, method="tridiag")
    ((u - ud_q) ** 2).mean(dim=-1).sum().backward()
    gate = rel_err(tk.cf_unpack(gT, aux), ke.grad)
    log(f"phase 5 parity gate: rel={gate:.3e} (limit {GATE_TOL})")
    if not gate < GATE_TOL:
        raise AssertionError(f"bench parity gate failed: {gate:.3e}")
    main_path = dict(tk.launches)
    log(f"1D main-path launches: {main_path}")
    for k, v in main_path.items():
        if v < 1:
            raise AssertionError(f"kernel {k} was not launched by the path")
    del u, ke, ud_q, gT
    torch.cuda.empty_cache()

    # -- phase 6: timing at the bench workload.  The chain is timed
    # chained (timeit_chained), kernel and plain version in turns.  The step
    # is timed by the profiler's kernel time a call (the kernel alone, and
    # the plain version's kernels), as K2 and K7 are.
    profile_split(torch, lambda: fit_kappa(mesh, f, u_data, steps=STEPS),
                  "phase 6", card)
    udT, cols, B, u_l, u_r = (aux["udT"], aux["cols"], aux["B"], aux["u_l"],
                              aux["u_r"])
    _, aux_s = tk.cf_packed_operands(mesh, ke0, assemble_load(mesh, fv),
                                     u_data[0], block_lanes=BLOCK_LANES)
    cols_s = aux_s["cols"]
    NB = tk.k1_bucket(keT0.shape[0])
    L = tk.k1_plan(keT0.shape[0])
    ms = {}
    for name, ax, udp, cl in (("chain", aux, udT, cols),
                              ("chain_shared", aux_s, None, cols_s)):
        ms[name] = best = timed_pair(
            lambda k, ax=ax: tk.kappa_sgd_chain_cf(k, ax, CHAIN_K, LR,
                                                   scale)[1],
            lambda k, udp=udp, cl=cl: tk._cf_chain_plain(
                k, udp, cl, B, scale, u_l, u_r, CHAIN_K, LR)[1],
            keT0, STEPS // CHAIN_K)
        log(f"phase 6 {name} (NB={NB}, L={L}, {CHAIN_K} steps a launch, "
            f"B={BATCH}): kernel {best['kernel']:.4f} ms, plain "
            f"{best['plain']:.4f} ms; kernel "
            f"{BATCH * CHAIN_K / best['kernel'] * 1e3:.6e} grad-solves/s "
            f"[{card}]")
    for name, ax, udp, cl in (("step", aux, udT, cols),
                              ("step_shared", aux_s, None, cols_s)):
        ms[name] = res = {
            "kernel": device_ms(torch, lambda k, ax=ax: (
                tk.kappa_mse_step_cf_packed(k, ax, scale)[1]), keT0, 20,
                "cf_lanes_kernel"),
            "plain": device_ms(torch, lambda k, udp=udp, cl=cl: (
                tk._cf_step_plain(k, udp, cl, B, scale, u_l, u_r)[1]),
                keT0, 4)}
        log(f"phase 6 {name} kernel time a call (profiler): kernel "
            f"{res['kernel']:.4f} ms, plain {res['plain']:.4f} ms [{card}]")
    # with shared u_data only κ moves (κ in, κ′ out, the 4 B loss row)
    for name in ("chain_shared", "step_shared"):
        steps = CHAIN_K if name.startswith("chain") else 1
        b_ms, b_by = bound(K1_OPS_PER_ROW_STEP * n * BATCH * steps,
                           BATCH * (2 * N_ELEMENTS * 4 + 4))
        log(f"phase 6 {name}: bound {b_ms:.4f} ms ({b_by}) [{card}]")
    del aux_s, cols_s
    torch.cuda.empty_cache()

    # the chain in the other row buckets (bf16 u_data)
    for nb_n in K1_BUCKET_NS:
        mb, fb, udb, gb = problem(nb_n, BATCH_BUCKETS, seed=nb_n)
        keb, auxb = tk.cf_packed_operands(
            mb, 1.0 + 0.3 * torch.rand(BATCH_BUCKETS, nb_n, generator=gb,
                                       device=dev),
            assemble_load(mb, fb), udb, operand_dtype=torch.bfloat16)
        fns = {"kernel": lambda k: tk.kappa_sgd_chain_cf(
            k, auxb, CHAIN_K, LR, 2.0 / (nb_n + 1))[1]}
        best = timed_turns(fns, keb, 4, ("kernel", "kernel"))
        log(f"phase 6 chain at n={nb_n} (NB={tk.k1_bucket(keb.shape[0])}, "
            f"L={tk.k1_plan(keb.shape[0])}, B={BATCH_BUCKETS}, bf16 u_data, "
            f"{CHAIN_K} steps): {best['kernel']:.4f} ms [{card}]")
        del mb, fb, udb, keb, auxb, fns
        torch.cuda.empty_cache()
    log("phase 6 -Xptxas -v of K1's bodies:")
    for line in ptxas_report(("cf_lanes_kernel",)):
        log(line)

    # Both timed functions map κ to κ′ and must read κ (f32) and the bf16
    # u_data plane once and write κ′ once (the loss row: 4 B a scenario).
    nbytes = BATCH * (2 * N_ELEMENTS * 4 + n * udT.element_size() + 4)
    ops_chain = K1_OPS_PER_ROW_STEP * n * BATCH * CHAIN_K
    ops_step = K1_OPS_PER_ROW_STEP * n * BATCH
    return [
        kernel_entry("cf_chain", CU_SOURCE, f"{JAX_KERNEL}:445",
                     main_path["chain"], max_abs["chain"],
                     ms["chain"]["kernel"], ms["chain"]["plain"], ops_chain,
                     nbytes),
        kernel_entry("cf_step", CU_SOURCE, f"{JAX_KERNEL}:132",
                     main_path["step"], max_abs["step"],
                     ms["step"]["kernel"], ms["step"]["plain"], ops_step,
                     nbytes),
    ]


def check_rule(name, kernel, plain32, plain64, what, slack=1e-6):
    """The tolerance rule of phase 7: the kernel's relative max error
    against the f64 plain run may be at most twice the f32 plain run's,
    plus ``slack`` (1e-6; K7's bf16 ablation C adds a bf16 rounding step,
    probes/k7_ablation.rule_slack).  Returns both errors."""
    import torch

    if not bool(torch.isfinite(kernel).all()):
        raise AssertionError(f"{what}: {name} is not finite")
    ek, ep = rel_err(kernel, plain64), rel_err(plain32, plain64)
    if not ek <= 2.0 * ep + slack:
        raise AssertionError(f"{what}: {name} error {ek:.3e} exceeds "
                             f"2 x {ep:.3e} + {slack:.3g}")
    return ek, ep


def profile_split(torch, fn, label, card, what="fit_kappa", cpu=True):
    """Device time by kernel name of one call of ``fn`` under
    torch.profiler; logs the busy time, the window and the top rows, and
    returns (rows (name, count, ms), busy ms).  ``cpu=False`` records the
    device's activity alone: a call of ~10⁵ host operations would take
    the profiler tens of seconds to process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # a user annotation (torch.optim's "Optimizer.step#Adam.step") also
    # shows as a device range over the kernels it spans: count kernels only
    spans = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in spans]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    log(f"{label} profile of one {what} call: {busy:.1f} ms of device "
        f"time in a {window * 1e3:.1f} ms window, device idle "
        f"{100 * max(0.0, 1 - busy / (window * 1e3)):.1f}% [{card}]")
    for key, count, t in rows[:12]:
        log(f"  {t:9.2f} ms {100 * t / busy:5.1f}% x{count:<5d} {key[:90]}")
    return rows, busy


def plan_text(plan):
    """A K3b/K4b plan as one log phrase."""
    if plan.route == "workspace":
        return ("route workspace (one block a scenario, CG vectors in a "
                "global workspace)")
    return (f"route cluster, C = {plan.cluster}, {plan.block_bytes} bytes "
            f"a block, {plan.threads} threads, {plan.blocks_per_sm} blocks "
            f"an SM by shared memory")


def workspace_route(launch, nodes):
    """The K3b/K4b wrapper ``launch`` pinned to the workspace route."""
    from difffe_tpu_torch.ops.kernels.stencil_cg_kernel import workspace_plan

    ws = workspace_plan(nodes)
    return lambda *args: launch(*args, plan=ws)


def route_timing(label, call, state0, length, iters, solves, shape,
                 planes, item, B, capacity, card):
    """K3a, K3b, K4a or K4b at the main path's workload on both routes, in
    one run: the plan's route against the workspace route (the first
    design) in turns (workspace, plan, plan, workspace), every cluster size
    whose
    block fits, and the plan's route at twice the iterations, whose
    difference gives one CG iteration's time.  ``call(state, iters, plan)``
    launches the wrapper once and returns the next state of a chain from
    ``state0``; ``solves`` is 2 (K3b, K4b) or 1 (K3a, K4a);
    ``capacity(C, threads)`` the card's clusters at once.  Logs; returns
    (plan ms, workspace ms)."""
    from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as sk
    from difffe_tpu_torch.utils.profiling import timeit_chained

    nodes, limit = math.prod(shape), sk.smem_optin(0)
    plan = sk.cluster_plan(nodes, planes, item, limit)

    def timed(p, n_iters=iters):
        return timeit_chained(lambda s: call(s, n_iters, p), state0,
                              length=length, repeats=2).min_s * 1e3

    best = {"plan": float("inf"), "workspace": float("inf")}
    for which in ("workspace", "plan", "plan", "workspace"):
        p = plan if which == "plan" else sk.workspace_plan(nodes)
        best[which] = min(best[which], timed(p))
    where = (f"{'x'.join(map(str, shape))} nodes, B={B}, {solves} x {iters} "
             f"iters")
    log(f"{label} at {where}: the plan's route ({plan_text(plan)}) "
        f"{best['plan']:.4f} ms, the workspace route (the first design) "
        f"{best['workspace']:.4f} ms, {best['workspace'] / best['plan']:.2f}"
        f"x [{card}]")
    sizes = []
    for c in sk.CLUSTER_SIZES:
        try:
            p = sk.cluster_layout(nodes, planes, item, c, limit)
        except ValueError:
            continue
        sizes.append(f"C={c} ({p.threads} threads, {p.block_bytes} B, "
                     f"{capacity(c, p.threads)} clusters at once) "
                     f"{timed(p):.4f} ms")
    log(f"{label} by cluster size at {where}: " + "; ".join(sizes)
        + f" [{card}]")
    if plan.route == "cluster":
        twice = timed(plan, 2 * iters)
        active = capacity(plan.cluster, plan.threads)
        waves = -(-B // active)
        per = (twice - best["plan"]) / (solves * iters) * 1e3
        log(f"{label} one CG iteration ({solves} x {2 * iters} iters "
            f"{twice:.4f} ms less {solves} x {iters}, over "
            f"{solves * iters}): {per:.3f} µs a launch; {active} clusters "
            f"at once, {waves} waves: {per / waves:.3f} µs a cluster "
            f"[{card}]")
    return best["plan"], best["workspace"]


def run_2d(torch, dev, card):
    """Phases 7-9; returns the K3 entries of the kernels line."""
    from difffe_tpu_torch import fit_kappa
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as sk
    from difffe_tpu_torch.ops.kernels._build import load_library
    from difffe_tpu_torch.ops.stencil import (StructuredGrid,
                                              kappa_lu_from_elements,
                                              residual_vjp_manual)
    from difffe_tpu_torch.solver import solve_poisson_batched

    f64 = torch.float64
    max_abs = {"cg": 0.0, "cg_workspace": 0.0, "cg2": 0.0,
               "cg2_workspace": 0.0}

    def problem(n, B, g_nonzero, seed):
        grid = StructuredGrid.unit(n, n)
        gen = torch.Generator(device=dev).manual_seed(seed)
        opts = dict(dtype=f64, device=dev)
        kl = 1.2 + 0.6 * torch.rand(B, n, n, generator=gen, **opts)
        ku = 1.2 + 0.6 * torch.rand(B, n, n, generator=gen, **opts)
        xs = torch.linspace(0.0, 1.0, n + 1, **opts)
        Y, X = torch.meshgrid(xs, xs, indexing="ij")
        bump = torch.sin(math.pi * X) * torch.sin(math.pi * Y)
        f = 10.0 * bump * (1.0 + 0.2 * torch.rand(B, 1, 1, generator=gen,
                                                  **opts))
        g = 0.3 * X + 0.1 * Y if g_nonzero else torch.zeros_like(X)
        ud = 0.05 * bump * (1.0 + torch.rand(B, 1, 1, generator=gen,
                                             **opts))
        return grid, (kl, ku, f, g, ud)

    def k3b_steps(grid, arrays, dtype, cg2, steps=4):
        """A cold SGD step, then warm ones, each through ``cg2``."""
        kl, ku, f, g, ud = (a.to(dtype).contiguous() for a in arrays)
        H, W = grid.node_shape
        out, state = [], None
        for _ in range(steps):
            C, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), f, g)
            x0, lam0 = state if state else (x0, torch.zeros_like(b))
            x, lam = cg2(D, b, Minv, x0, lam0, ud, 2.0 / (H * W), K3B_ITERS)
            (gl, gu), _, _ = residual_vjp_manual(grid, (kl, ku), f, g, x,
                                                 lam, C=C)
            out.append({"x": x, "lam": lam, "grad": torch.stack([gl, gu])})
            state = (x, lam)
            kl, ku = kl - LR * gl, ku - LR * gu
        return out

    # -- phase 7: K3a and K3b against their plain versions; K3b on its
    # plan's route and on the workspace route (the first design) forced
    t0 = time.perf_counter()
    lib = load_library()
    for n, B in K3_CASES:
        plan = sk.cluster_plan((n + 1) ** 2, 5, 4, sk.smem_optin(0))
        active = (lib.difffe_stencil_cg2_clusters(
            n + 1, n + 1, plan.cluster, plan.threads) if plan.cluster else 0)
        log(f"phase 7 K3a/K3b plan at {n}²: {plan_text(plan)}, {active} "
            f"clusters at once")
        ws = workspace_route(sk._launch_cg2, (n + 1) ** 2)
        for g_nonzero in (False, True):
            grid, arrays = problem(n, B, g_nonzero, seed=n + B + g_nonzero)
            runs = [k3b_steps(grid, arrays, dt, cg2) for dt, cg2 in (
                (torch.float32, sk._cg2), (torch.float32, ws),
                (torch.float32, sk._cg2_plain), (f64, sk._cg2_plain))]
            again = k3b_steps(grid, arrays, torch.float32, sk._cg2, steps=1)
            if not all(torch.equal(again[0][k], runs[0][0][k])
                       for k in ("x", "lam")):
                raise AssertionError(f"phase 7 K3b n={n} B={B}: two "
                                     f"launches differ")
            worst = {}
            for step, (k, w, p, q) in enumerate(zip(*runs)):
                for key in ("x", "lam", "grad"):
                    for name, out in (("cg2", k), ("cg2_workspace", w)):
                        ek, ep = check_rule(
                            f"K3b {name}", out[key], p[key], q[key],
                            f"n={n} B={B} step {step} {key}")
                        worst[name, key] = max(worst.get((name, key), (0, 0)),
                                               (ek, ep))
                        max_abs[name] = max(max_abs[name], float(
                            (out[key] - q[key]).abs().max()))
            log(f"phase 7 K3b n={n} B={B} g={'nonzero' if g_nonzero else 0}"
                f" cold+3 warm: worst (kernel, f32 plain) rel err vs f64 on "
                f"the plan's route and the workspace route; two launches "
                f"equal bit for bit: " + " ".join(
                    f"{k}{'' if r == 'cg2' else ' ws'}=({a:.2e}, {b:.2e})"
                    for (r, k), (a, b) in worst.items()))
            del runs, again
            # K3a on the plan's route (K3b's plan) and on the workspace
            # route (the first design) forced
            solvers = {"cg" if plan.cluster else "cg_workspace": sk._cg}
            if plan.cluster:
                solvers["cg_workspace"] = workspace_route(sk._launch_cg,
                                                          (n + 1) ** 2)
            sols = {}
            for name, dt, cg in (
                    *((r, torch.float32, cg) for r, cg in solvers.items()),
                    ("f32", torch.float32, sk._cg_plain),
                    ("f64", f64, sk._cg_plain)):
                kl, ku, f, g, ud = (a.to(dt).contiguous() for a in arrays)
                _, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), f, g)
                sols[name] = (cg(D, b, Minv, x0, K3A_ITERS),
                              cg(D, ud, Minv, torch.zeros_like(ud),
                                 K3A_ITERS))
                if name in solvers and not torch.equal(
                        cg(D, b, Minv, x0, K3A_ITERS), sols[name][0]):
                    raise AssertionError(f"phase 7 K3a n={n} B={B} {name}: "
                                         f"two launches differ")
            errs = []
            for name in solvers:
                for i in range(2):
                    ek, ep = check_rule(f"K3a {name}", sols[name][i],
                                        sols["f32"][i], sols["f64"][i],
                                        f"n={n} B={B} solve {i}")
                    errs.append(f"{name} {('solve', 'adjoint-style')[i]} "
                                f"({ek:.2e}, {ep:.2e})")
                    max_abs[name] = max(max_abs[name], float(
                        (sols[name][i] - sols["f64"][i]).abs().max()))
            log(f"phase 7 K3a n={n} B={B} g={'nonzero' if g_nonzero else 0}"
                f" {K3A_ITERS} iters, (kernel, f32 plain) rel err vs f64 on "
                f"the plan's route"
                + (" and the workspace route" if plan.cluster else "")
                + "; two launches equal bit for bit: " + ", ".join(errs))
            del sols, arrays
            torch.cuda.empty_cache()
    log(f"phase 7 kernel vs plain: {time.perf_counter() - t0:.1f} s")

    # -- phase 8: the 2D main path, with launch counts
    mesh = FEMesh.rectangle(N_2D, N_2D, dtype=torch.float32)
    if mesh.device.type != dev.type:
        raise AssertionError(f"the mesh factory put the mesh on "
                             f"{mesh.device}")
    grid, ne, nn = mesh.grid, mesh.n_elements, mesh.n_nodes
    H, W = grid.node_shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x, y = mesh.nodes.T
    f = (10.0 * torch.sin(math.pi * x) * torch.sin(math.pi * y)).expand(
        BATCH_2D, nn)
    k_true = 1.2 + 0.6 * torch.rand(BATCH_2D, ne, generator=gen, device=dev)
    for k in sk.launches:
        sk.launches[k] = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        u_data = solve_poisson_batched(mesh, k_true, f, cg_tol=0.0,
                                       cg_maxiter=K3A_ITERS)
    kappa, info = fit_kappa(mesh, f, u_data, steps=STEPS_2D, lr=LR_2D)
    hist = info["loss_history"]
    ke = torch.ones(BATCH_2D, ne, device=dev, requires_grad=True)
    (solve_poisson_batched(mesh, ke, f, cg_tol=0.0, cg_maxiter=GRAD_ITERS)
     ** 2).sum().backward()
    torch.cuda.synchronize()
    main_path = dict(sk.launches)
    log(f"phase 8 fit_kappa: path={info['path']} iters={info['iters']} "
        f"warm={info['warm']} loss_history[0]={float(hist[0]):.6e} "
        f"loss_history[-1]={float(hist[-1]):.6e} "
        f"eval_loss={info['eval_loss']:.6e} "
        f"({time.perf_counter() - t0:.2f} s with u_data and the gradient)")
    log(f"2D main-path launches: {main_path}")
    if info["path"] != "stencil2d_fused":
        raise AssertionError(f"fit_kappa took path {info['path']}")
    if info["iters"] != K3B_ITERS or info["warm"] is not True:
        raise AssertionError(f"iteration policy {info['iters']}, "
                             f"warm={info['warm']}")
    if main_path["cg2"] != STEPS_2D or main_path["cg2_workspace"]:
        raise AssertionError(f"K3b launches {main_path}: {STEPS_2D} on the "
                             f"cluster route expected")
    # the u_data solve, the gradient's forward and adjoint
    if main_path["cg"] != 3 or main_path["cg_workspace"]:
        raise AssertionError(f"K3a launches {main_path}: 3 on the cluster "
                             f"route expected")
    if kappa.shape != (BATCH_2D, ne) or not bool(
            torch.isfinite(kappa).all()):
        raise AssertionError("fit_kappa's kappa is not finite of shape "
                             f"{(BATCH_2D, ne)}")
    if not info["eval_loss"] < 0.5 * float(hist[0]):
        raise AssertionError("eval_loss is not below half the first loss")

    def grad_plain(dtype):
        kl, ku = kappa_lu_from_elements(
            grid, torch.ones(BATCH_2D, ne, dtype=dtype, device=dev))
        fg = f.to(dtype).reshape(BATCH_2D, H, W)
        g0 = mesh.bc_values.to(dtype).reshape(H, W)
        C, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), fg, g0)
        u = sk._cg_plain(D, b, Minv, x0, GRAD_ITERS)
        lam = sk._cg_plain(D, 2.0 * u, Minv, torch.zeros_like(u),
                           GRAD_ITERS)
        (gl, gu), _, _ = residual_vjp_manual(grid, (kl, ku), fg, g0, u, lam,
                                             C=C)
        return torch.stack([gl, gu], dim=-1).reshape(BATCH_2D, ne)

    ek, ep = check_rule("K3a gradient", ke.grad, grad_plain(torch.float32),
                   grad_plain(f64), "phase 8 κ gradient")
    log(f"phase 8 κ gradient of Σu² through K3a (forward + adjoint, "
        f"{GRAD_ITERS} iters): rel err vs f64 plain {ek:.3e}, f32 plain "
        f"{ep:.3e}")
    del ke, kappa, info
    torch.cuda.empty_cache()

    # -- phase 9: timing at the main path's workload
    kl, ku = kappa_lu_from_elements(grid, k_true)
    fg = f.reshape(BATCH_2D, H, W)
    g0 = mesh.bc_values.reshape(H, W)
    ud = u_data.reshape(BATCH_2D, H, W).contiguous()
    _, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), fg, g0)
    scale = 2.0 / (H * W)
    state0 = (x0, torch.zeros_like(b))
    ms = {
        "cg2": timed_pair(
            lambda s: sk._cg2(D, b, Minv, *s, ud, scale, K3B_ITERS),
            lambda s: sk._cg2_plain(D, b, Minv, *s, ud, scale, K3B_ITERS),
            state0, 3),
        "cg": timed_pair(
            lambda v: sk._cg(D, b, Minv, v, K3A_ITERS),
            lambda v: sk._cg_plain(D, b, Minv, v, K3A_ITERS), x0, 2),
    }
    for name, iters, solves in (("cg2", K3B_ITERS, 2), ("cg", K3A_ITERS, 1)):
        best = ms[name]
        log(f"phase 9 {name}: kernel {best['kernel']:.4f} ms/launch, plain "
            f"{best['plain']:.4f} ms/launch ({N_2D}², B={BATCH_2D}, "
            f"{solves} x {iters} iters; kernel "
            f"{BATCH_2D / best['kernel'] * 1e3:.6e} scenarios/s) [{card}]")
    _, ms["cg2_workspace"] = route_timing(
        "phase 9 K3b", lambda s, n, p: sk._launch_cg2(
            D, b, Minv, *s, ud, scale, n, plan=p), state0, 3, K3B_ITERS, 2,
        (H, W), 5, 4, BATCH_2D,
        lambda c, t: lib.difffe_stencil_cg2_clusters(H, W, c, t), card)
    _, ms["cg_workspace"] = route_timing(
        "phase 9 K3a", lambda v, n, p: sk._launch_cg(
            D, b, Minv, v, n, plan=p), x0, 2, K3A_ITERS, 1, (H, W), 5, 4,
        BATCH_2D, lambda c, t: lib.difffe_stencil_cg_clusters(H, W, c, t),
        card)

    def fit(**kw):
        return fit_kappa(mesh, f, u_data, steps=STEPS_2D, lr=LR_2D, **kw)

    fit()
    for eval_final in (True, False):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(eval_final=eval_final)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        log(f"phase 9 fit_kappa host time, {STEPS_2D} steps, "
            f"eval_final={eval_final}: " + ", ".join(f"{t:.4f}" for t in
                                                    times)
            + f" s; {BATCH_2D * STEPS_2D / min(times):.6e} grad-solves/s "
            f"[{card}]")

    profile_split(torch, fit, "phase 9", card)

    n_nodes = BATCH_2D * H * W
    return [
        kernel_entry("stencil_cg", K3_SOURCE, f"{JAX_K3}:191",
                     main_path["cg"], max_abs["cg"], ms["cg"]["kernel"],
                     ms["cg"]["plain"],
                     K3_OPS_PER_NODE_ITER * n_nodes * K3A_ITERS,
                     9 * n_nodes * 4),
        kernel_entry("stencil_cg_workspace", K3_SOURCE, f"{JAX_K3}:191",
                     main_path["cg_workspace"], max_abs["cg_workspace"],
                     ms["cg_workspace"], ms["cg"]["plain"],
                     K3_OPS_PER_NODE_ITER * n_nodes * K3A_ITERS,
                     9 * n_nodes * 4),
        kernel_entry("stencil_cg2", K3_SOURCE, f"{JAX_K3}:412",
                     main_path["cg2"], max_abs["cg2"], ms["cg2"]["kernel"],
                     ms["cg2"]["plain"],
                     K3_OPS_PER_NODE_ITER * n_nodes * K3B_ITERS * 2,
                     12 * n_nodes * 4),
        kernel_entry("stencil_cg2_workspace", K3_SOURCE, f"{JAX_K3}:412",
                     main_path["cg2_workspace"], max_abs["cg2_workspace"],
                     ms["cg2_workspace"], ms["cg2"]["plain"],
                     K3_OPS_PER_NODE_ITER * n_nodes * K3B_ITERS * 2,
                     12 * n_nodes * 4),
    ]


def run_3d(torch, dev, card):
    """Phases 10-12; returns the K4 entries of the kernels line."""
    from difffe_tpu_torch import fit_kappa
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.kernels import stencil3d_cg_kernel as tk
    from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as sk
    from difffe_tpu_torch.ops.kernels._build import load_library
    from difffe_tpu_torch.ops.stencil3d import (StructuredGrid3,
                                                residual_vjp_manual_3d)
    from difffe_tpu_torch.solver import solve_poisson_batched

    f64 = torch.float64
    bf16 = torch.bfloat16
    max_abs = {"cg3": 0.0, "cg3_workspace": 0.0, "cg3_2": 0.0,
               "cg3_2_workspace": 0.0}
    lib = load_library()

    def problem(nx, ny, nz, B, g_nonzero, seed):
        grid = StructuredGrid3.unit(nx, ny, nz)
        gen = torch.Generator(device=dev).manual_seed(seed)
        opts = dict(dtype=f64, device=dev)
        k = 1.2 + 0.6 * torch.rand(B, grid.n_elements, generator=gen, **opts)
        Z, Y, X = torch.meshgrid(*(torch.linspace(0.0, 1.0, n + 1, **opts)
                                   for n in (nz, ny, nx)), indexing="ij")
        bump = (torch.sin(math.pi * X) * torch.sin(math.pi * Y)
                * torch.sin(math.pi * Z))
        f = 10.0 * bump * (1.0 + 0.2 * torch.rand(B, 1, 1, 1, generator=gen,
                                                  **opts))
        g = 0.3 * X + 0.1 * Y - 0.2 * Z if g_nonzero else torch.zeros_like(X)
        ud = 0.05 * bump * (1.0 + torch.rand(B, 1, 1, 1, generator=gen,
                                             **opts))
        return grid, (k, f, g, ud)

    def operands(grid, k, f, g, operand_dtype):
        """K4's operands in k's dtype.  With bf16 storage every run takes
        the planes the f32 run stores, so all three share one operator."""
        C, D, b, Minv, x0, _ = tk._prepare3(grid, k, f, g)
        if operand_dtype is not None:
            _, D, _, Minv, _, _ = tk._prepare3(
                grid, k.float(), f.float(), g.float(),
                operand_dtype=operand_dtype)
        return C, D, b, Minv, x0

    def k4b_steps(grid, arrays, dtype, cg3_2, operand_dtype, steps=3):
        """A cold SGD step, then warm ones, each through ``cg3_2``.  With
        bf16 storage κ stays put: κs that differ in their last bits between
        the runs could round a plane to another bf16 value."""
        k, f, g, ud = (a.to(dtype).contiguous() for a in arrays)
        out, state = [], None
        lr = 0.0 if operand_dtype else 100.0 * k.shape[0] / 256.0
        for _ in range(steps):
            C, D, b, Minv, x0 = operands(grid, k, f, g, operand_dtype)
            x0, lam0 = state if state else (x0, torch.zeros_like(b))
            x, lam = cg3_2(D, b, Minv, x0, lam0, ud, 2.0 / b.numel(),
                           K4B_ITERS)
            gk, _, _ = residual_vjp_manual_3d(grid, k, f, g, x, lam, C=C)
            out.append({"x": x, "lam": lam, "grad": gk})
            state = (x, lam)
            k = k - lr * gk
        return out

    # -- phase 10: K4a and K4b against their plain versions, each on its
    # plan's route and, where that is the cluster route, on the workspace
    # route (the first design) forced
    t0 = time.perf_counter()
    for nx, ny, nz, B in K4_CASES:
        storages = (None, bf16) if nx == 16 else (None,)
        nodes = (nx + 1) * (ny + 1) * (nz + 1)
        for od in storages:
            plan = sk.cluster_plan(nodes, 7, 2 if od else 4, sk.smem_optin(0))
            active = (lib.difffe_stencil3d_cg2_clusters(
                nz + 1, ny + 1, nx + 1, plan.cluster, plan.threads,
                int(od is not None)) if plan.cluster else 0)
            log(f"phase 10 K4a/K4b plan at {nx}x{ny}x{nz}"
                f"{' bf16' if od else ''}: {plan_text(plan)}, {active} "
                f"clusters at once")
        for g_nonzero in (False, True):
            grid, arrays = problem(nx, ny, nz, B, g_nonzero,
                                   seed=nx * ny * nz + B + g_nonzero)
            for od in storages:
                tag = (f"{nx}x{ny}x{nz} B={B} "
                       f"g={'nonzero' if g_nonzero else 0}"
                       f"{' bf16' if od else ''}")
                plan = sk.cluster_plan(nodes, 7, 2 if od else 4,
                                       sk.smem_optin(0))
                kernels = {"cg3_2" if plan.cluster else "cg3_2_workspace":
                           tk._cg3_2}
                if plan.cluster:
                    kernels["cg3_2_workspace"] = workspace_route(
                        tk._launch_cg3_2, nodes)
                runs = [k4b_steps(grid, arrays, torch.float32, cg, od)
                        for cg in kernels.values()]
                runs += [k4b_steps(grid, arrays, dt, tk._cg3_2_plain, od)
                         for dt in (torch.float32, f64)]
                again = k4b_steps(grid, arrays, torch.float32, tk._cg3_2,
                                  od, steps=1)
                if not all(torch.equal(again[0][k], runs[0][0][k])
                           for k in ("x", "lam")):
                    raise AssertionError(f"phase 10 K4b {tag}: two launches "
                                         f"differ")
                worst = {}
                for step, outs in enumerate(zip(*runs)):
                    p, q = outs[-2:]
                    for key in ("x", "lam", "grad"):
                        for name, kk in zip(kernels, outs):
                            ek, ep = check_rule(
                                f"K4b {name}", kk[key], p[key], q[key],
                                f"{tag} step {step} {key}")
                            worst[name, key] = max(
                                worst.get((name, key), (0, 0)), (ek, ep))
                            if od is None:  # the main path's f32 storage
                                max_abs[name] = max(max_abs[name], float(
                                    (kk[key] - q[key]).abs().max()))
                log(f"phase 10 K4b {tag} cold+2 warm: worst (kernel, f32 "
                    f"plain) rel err vs f64 on the plan's route"
                    + (" and the workspace route" if plan.cluster else "")
                    + "; two launches equal bit for bit: " + " ".join(
                        f"{k}{' ws' if r == 'cg3_2_workspace' else ''}="
                        f"({a:.2e}, {b:.2e})"
                        for (r, k), (a, b) in worst.items()))
                del runs, again
                # K4a on the plan's route (the same plan as K4b's) and,
                # where that is the cluster route, the workspace route
                solvers = {"cg3" if plan.cluster else "cg3_workspace":
                           tk._cg3}
                if plan.cluster:
                    solvers["cg3_workspace"] = workspace_route(
                        tk._launch_cg3, nodes)
                sols = {}
                for name, dt, cg in (
                        *((r, torch.float32, cg)
                          for r, cg in solvers.items()),
                        ("f32", torch.float32, tk._cg3_plain),
                        ("f64", f64, tk._cg3_plain)):
                    k, f, g, ud = (a.to(dt).contiguous() for a in arrays)
                    _, D, b, Minv, x0 = operands(grid, k, f, g, od)
                    sols[name] = (cg(D, b, Minv, x0, K4A_ITERS),
                                  cg(D, ud, Minv, torch.zeros_like(ud),
                                     K4A_ITERS))
                    if name in solvers and not torch.equal(
                            cg(D, b, Minv, x0, K4A_ITERS), sols[name][0]):
                        raise AssertionError(f"phase 10 K4a {tag} {name}: "
                                             f"two launches differ")
                errs = []
                for name in solvers:
                    for i in range(2):
                        ek, ep = check_rule(
                            f"K4a {name}", sols[name][i], sols["f32"][i],
                            sols["f64"][i], f"{tag} solve {i}")
                        errs.append(f"{name} {('solve', 'adjoint-style')[i]}"
                                    f" ({ek:.2e}, {ep:.2e})")
                        if od is None:
                            max_abs[name] = max(max_abs[name], float(
                                (sols[name][i] - sols["f64"][i]).abs()
                                .max()))
                log(f"phase 10 K4a {tag} {K4A_ITERS} iters, (kernel, f32 "
                    f"plain) rel err vs f64 on the plan's route"
                    + (" and the workspace route" if plan.cluster else "")
                    + "; two launches equal bit for bit: " + ", ".join(errs))
                del sols
            del arrays
            torch.cuda.empty_cache()
    log(f"phase 10 kernel vs plain: {time.perf_counter() - t0:.1f} s")

    # -- phase 11: the 3D main path, with launch counts
    mesh = FEMesh.box(N_3D, N_3D, N_3D, dtype=torch.float32)
    if mesh.device.type != dev.type:
        raise AssertionError(f"the mesh factory put the mesh on "
                             f"{mesh.device}")
    grid, ne, nn = mesh.grid, mesh.n_elements, mesh.n_nodes
    shape = (BATCH_3D,) + grid.node_shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x, y, z = mesh.nodes.T
    f = (10.0 * torch.sin(math.pi * x) * torch.sin(math.pi * y)
         * torch.sin(math.pi * z)).expand(BATCH_3D, nn)
    k_true = 1.2 + 0.6 * torch.rand(BATCH_3D, ne, generator=gen, device=dev)
    for k in tk.launches:
        tk.launches[k] = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        u_data = solve_poisson_batched(mesh, k_true, f, cg_tol=0.0,
                                       cg_maxiter=K4A_ITERS)
    kappa, info = fit_kappa(mesh, f, u_data, lr=LR_3D)
    hist = info["loss_history"]
    ke = torch.ones(BATCH_3D, ne, device=dev, requires_grad=True)
    (solve_poisson_batched(mesh, ke, f, cg_tol=0.0, cg_maxiter=GRAD_ITERS)
     ** 2).sum().backward()
    torch.cuda.synchronize()
    main_path = dict(tk.launches)
    log(f"phase 11 fit_kappa: path={info['path']} iters={info['iters']} "
        f"warm={info['warm']} loss_history[0]={float(hist[0]):.6e} "
        f"loss_history[-1]={float(hist[-1]):.6e} "
        f"eval_loss={info['eval_loss']:.6e} "
        f"({time.perf_counter() - t0:.2f} s with u_data and the gradient)")
    log(f"3D main-path launches: {main_path}")
    if info["path"] != "stencil3d_kernel":
        raise AssertionError(f"fit_kappa took path {info['path']}")
    if info["iters"] != K4B_ITERS or info["warm"] is not False:
        raise AssertionError(f"iteration policy {info['iters']}, "
                             f"warm={info['warm']}")
    # u_data, the eval solve, the gradient's forward and adjoint
    if main_path != {"cg3": 4, "cg3_workspace": 0, "cg3_2": STEPS_3D,
                     "cg3_2_workspace": 0}:
        raise AssertionError(f"K4 launches {main_path}")
    if not bool(torch.isfinite(hist).all()):
        raise AssertionError("fit_kappa's loss history is not finite")
    if kappa.shape != (BATCH_3D, ne) or not bool(
            torch.isfinite(kappa).all()):
        raise AssertionError("fit_kappa's kappa is not finite of shape "
                             f"{(BATCH_3D, ne)}")
    if not info["eval_loss"] < float(hist[0]):
        raise AssertionError("eval_loss is not below the first loss")

    def grad_plain(dtype):
        k = torch.ones(BATCH_3D, ne, dtype=dtype, device=dev)
        fg = f.to(dtype).reshape(shape)
        g0 = mesh.bc_values.to(dtype).reshape(grid.node_shape)
        C, D, b, Minv, x0, _ = tk._prepare3(grid, k, fg, g0)
        u = tk._cg3_plain(D, b, Minv, x0, GRAD_ITERS)
        lam = tk._cg3_plain(D, 2.0 * u, Minv, torch.zeros_like(u),
                            GRAD_ITERS)
        gk, _, _ = residual_vjp_manual_3d(grid, k, fg, g0, u, lam, C=C)
        return gk

    ek, ep = check_rule("K4a gradient", ke.grad, grad_plain(torch.float32),
                        grad_plain(f64), "phase 11 κ gradient")
    log(f"phase 11 κ gradient of Σu² through K4a (forward + adjoint, "
        f"{GRAD_ITERS} iters): rel err vs f64 plain {ek:.3e}, f32 plain "
        f"{ep:.3e}")
    del ke, kappa, info
    torch.cuda.empty_cache()

    # -- phase 12: timing at the main path's workload
    fg = f.reshape(shape)
    g0 = mesh.bc_values.reshape(grid.node_shape)
    ud = u_data.reshape(shape).contiguous()
    _, D, b, Minv, x0, _ = tk._prepare3(grid, k_true, fg, g0)
    scale = 2.0 / b.numel()
    state0 = (x0, torch.zeros_like(b))
    ms = {
        "cg3_2": timed_pair(
            lambda s: tk._cg3_2(D, b, Minv, *s, ud, scale, K4B_ITERS),
            lambda s: tk._cg3_2_plain(D, b, Minv, *s, ud, scale, K4B_ITERS),
            state0, 2),
        "cg3": timed_pair(
            lambda v: tk._cg3(D, b, Minv, v, K4A_ITERS),
            lambda v: tk._cg3_plain(D, b, Minv, v, K4A_ITERS), x0, 2),
    }
    for name, iters, solves in (("cg3_2", K4B_ITERS, 2),
                                ("cg3", K4A_ITERS, 1)):
        best = ms[name]
        log(f"phase 12 {name}: kernel {best['kernel']:.4f} ms/launch, plain "
            f"{best['plain']:.4f} ms/launch ({N_3D}³, B={BATCH_3D}, "
            f"{solves} x {iters} iters; kernel "
            f"{BATCH_3D / best['kernel'] * 1e3:.6e} scenarios/s) [{card}]")
    Dz, H, W = grid.node_shape
    _, ms["cg3_2_workspace"] = route_timing(
        "phase 12 K4b", lambda s, n, p: tk._launch_cg3_2(
            D, b, Minv, *s, ud, scale, n, plan=p), state0, 2, K4B_ITERS, 2,
        (Dz, H, W), 7, 4, BATCH_3D,
        lambda c, t: lib.difffe_stencil3d_cg2_clusters(Dz, H, W, c, t, 0),
        card)
    _, ms["cg3_workspace"] = route_timing(
        "phase 12 K4a", lambda v, n, p: tk._launch_cg3(
            D, b, Minv, v, n, plan=p), x0, 2, K4A_ITERS, 1, (Dz, H, W), 7,
        4, BATCH_3D,
        lambda c, t: lib.difffe_stencil3d_cg_clusters(Dz, H, W, c, t, 0),
        card)
    del D, b, Minv, x0, state0
    torch.cuda.empty_cache()
    # the shared-memory route at the README's other 3D size: 16³, B = 256,
    # 32 iterations (fit_kappa's policy at ≤ 16 a side)
    grid16, (k, f16, g16, ud16) = problem(16, 16, 16, 256, False, seed=16)
    k, f16, g16, ud16 = (a.float().contiguous() for a in (k, f16, g16, ud16))
    _, D, b, Minv, x0, _ = tk._prepare3(grid16, k, f16, g16)
    best = timed_pair(
        lambda s: tk._cg3_2(D, b, Minv, *s, ud16, 2.0 / b.numel(), 32),
        lambda s: tk._cg3_2_plain(D, b, Minv, *s, ud16, 2.0 / b.numel(), 32),
        (x0, torch.zeros_like(b)), 3)
    b_ms, _ = bound(K4_OPS_PER_NODE_ITER * b.numel() * 64,
                    14 * b.numel() * 4)
    log(f"phase 12 cg3_2 at 16³: kernel {best['kernel']:.4f} ms/launch, "
        f"plain {best['plain']:.4f} ms/launch (B=256, 2 x 32 iters; bound "
        f"{b_ms:.4f} ms) [{card}]")
    del D, b, Minv, x0, k, f16, g16, ud16
    torch.cuda.empty_cache()

    for eval_final in (True, False):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = fit_kappa(mesh, f, u_data, eval_final=eval_final)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if eval_final:
            log(f"phase 12 fit_kappa at the default lr: loss_history[0]="
                f"{float(info['loss_history'][0]):.6e} loss_history[-1]="
                f"{float(info['loss_history'][-1]):.6e} eval_loss="
                f"{info['eval_loss']:.6e}")
        log(f"phase 12 fit_kappa host time, {STEPS_3D} steps, "
            f"eval_final={eval_final}: " + ", ".join(f"{t:.4f}" for t in
                                                    times)
            + f" s; {BATCH_3D * STEPS_3D / min(times):.6e} grad-solves/s "
            f"[{card}]")
    profile_split(torch, lambda: fit_kappa(mesh, f, u_data), "phase 12",
                  card)

    n_nodes = BATCH_3D * nn
    return [
        kernel_entry("stencil3d_cg", K4_SOURCE, f"{JAX_K4}:153",
                     main_path["cg3"], max_abs["cg3"], ms["cg3"]["kernel"],
                     ms["cg3"]["plain"],
                     K4_OPS_PER_NODE_ITER * n_nodes * K4A_ITERS,
                     11 * n_nodes * 4),
        kernel_entry("stencil3d_cg_workspace", K4_SOURCE, f"{JAX_K4}:153",
                     main_path["cg3_workspace"], max_abs["cg3_workspace"],
                     ms["cg3_workspace"], ms["cg3"]["plain"],
                     K4_OPS_PER_NODE_ITER * n_nodes * K4A_ITERS,
                     11 * n_nodes * 4),
        kernel_entry("stencil3d_cg2", K4_SOURCE, f"{JAX_K4}:368",
                     main_path["cg3_2"], max_abs["cg3_2"],
                     ms["cg3_2"]["kernel"], ms["cg3_2"]["plain"],
                     K4_OPS_PER_NODE_ITER * n_nodes * K4B_ITERS * 2,
                     14 * n_nodes * 4),
        kernel_entry("stencil3d_cg2_workspace", K4_SOURCE, f"{JAX_K4}:368",
                     main_path["cg3_2_workspace"],
                     max_abs["cg3_2_workspace"], ms["cg3_2_workspace"],
                     ms["cg3_2"]["plain"],
                     K4_OPS_PER_NODE_ITER * n_nodes * K4B_ITERS * 2,
                     14 * n_nodes * 4),
    ]


def k2_bands(torch, kind, n, B, gen, dev):
    """f64 bands (d (B, n), e (B, n−1)) of ``kind``: 'random', strictly
    diagonally dominant SPD as tests/test_pallas_tridiag.py:15-22 builds
    them, or 'fem', the Dirichlet-eliminated bands of FEMesh.line(n − 1)
    with random per-element κ in [1.2, 1.8]."""
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.assembly import assemble_tridiag_1d

    opts = dict(dtype=torch.float64, device=dev)
    if kind == "random":
        e = -torch.rand(B, n - 1, generator=gen, **opts) - 0.1
        d = torch.rand(B, n, generator=gen, **opts) + 0.1
        d[:, :-1] -= e
        d[:, 1:] -= e
        return d, e
    mesh = FEMesh.line(n - 1, dtype=torch.float64, device=dev)
    k = 1.2 + 0.6 * torch.rand(B, n - 1, generator=gen, **opts)
    d, e = assemble_tridiag_1d(mesh, k)
    m = mesh.bc_mask
    p = 1.0 - m
    return p * d + m, p[:-1] * p[1:] * e


def run_facade_1d(torch, dev, card):
    """Phases 13-16; returns the K2 entries of the kernels line (its warp
    and block routes)."""
    from difffe_tpu_torch import (DifferentiableFESolver, NeuralPDE,
                                  recover_kappa_field, recover_kappa_scalar)
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops import tridiag as ttri
    from difffe_tpu_torch.ops.kernels import tridiag_kernel as tk
    from difffe_tpu_torch.solver import solve_poisson, solve_poisson_batched

    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=dev).manual_seed(13)

    def solve_and_grads(solve, d, e, F, w):
        """u and the (d, e, F) gradients of <w, u> through ``solve``."""
        ts = [t.clone().requires_grad_() for t in (d, e, F)]
        u = solve(*ts)
        u.backward(w)
        return [u.detach()] + [t.grad for t in ts]

    def residual(d, e, u, F):
        return float((ttri.tridiag_matvec(d, e, u) - F).abs().max()
                     / F.abs().max())

    # -- phase 13: K2 against its plain version
    t0 = time.perf_counter()
    names = ("u", "d", "e", "F")
    max_abs = 0.0
    for kind in ("random", "fem"):
        for n in K2_NS:
            for B in (b for b in K2_BS if b < BATCH_K2 or n <= 257):
                d64, e64 = k2_bands(torch, kind, n, B, gen, dev)
                F64 = torch.randn(B, n, generator=gen, dtype=f64, device=dev)
                w64 = torch.randn(B, n, generator=gen, dtype=f64, device=dev)
                for shared in ((False, True) if B > 1 else (False,)):
                    dd, ee = (d64[0], e64[0]) if shared else (d64, e64)
                    for dt in (f32, f64):
                        args = [t.to(dt) for t in (dd, ee, F64, w64)]
                        p = solve_and_grads(ttri.tridiag_solve, *args)
                        q = solve_and_grads(ttri.tridiag_solve,
                                            *(a.double() for a in args))
                        tag = (f"{kind} n={n} B={B} "
                               f"{'shared' if shared else 'batched'} {dt}")
                        # both routes where the warp route takes n: the
                        # same bits as each other and as the plain version
                        routes = (("warp", "block")
                                  if n <= tk.WARP_MAX_ROWS else ("block",))
                        ks = {r: solve_and_grads(
                            lambda *t, r=r: tk.tridiag_solve_kernel(
                                *t, plan=r), *args) for r in routes}
                        k = ks[tk.k2_plan(n, dt, B)]
                        for r, kr in ks.items():
                            for name, a, b in zip(names, kr, p):
                                if not torch.equal(a, b):
                                    raise AssertionError(
                                        f"{tag} {r} route: {name} is not the "
                                        f"plain version's bits (rel err "
                                        f"{rel_err(a, b):.3e})")
                        errs = [rel_err(a, c) for a, c in zip(k, q)]
                        if dt == f32:
                            for name, a, b, c in zip(names, k, p, q):
                                check_rule("K2", a, b, c, f"{tag} {name}")
                            if n == N_1D + 1:
                                max_abs = max(max_abs, *(float(
                                    (a - c).abs().max()) for a, c in zip(k, q)))
                        elif not max(errs) <= 1e-10:
                            raise AssertionError(f"{tag}: rel err {errs}")
                        elif kind == "fem" and n > 257:
                            # ‖Tu − F‖/‖F‖ exceeds 1e-12 for the f64 plain
                            # PCR (and for dense LU) at this condition, so
                            # the gate is the normwise backward error
                            dq, eq, Fq, wq = args
                            Bd, Be = dq.expand(B, n), eq.expand(B, n - 1)
                            for what, sol, rhs, ref in (
                                    ("u", k[0], Fq, q[0]),
                                    ("λ", k[3], wq, q[3])):
                                r_k = residual(Bd, Be, sol, rhs)
                                r_p = residual(Bd, Be, ref, rhs)
                                bw = r_k * float(rhs.abs().max()) / (
                                    float(Bd.abs().max() + 2 * Be.abs().max())
                                    * float(sol.abs().max())
                                    + float(rhs.abs().max()))
                                log(f"phase 13 {tag} {what}: ‖Tx − b‖/‖b‖ "
                                    f"kernel {r_k:.2e} plain {r_p:.2e}; "
                                    f"backward error {bw:.2e}; rel err vs "
                                    f"plain " + " ".join(
                                        f"{m}={v:.2e}"
                                        for m, v in zip(names, errs)))
                                if not bw <= 1e-11:
                                    raise AssertionError(
                                        f"{tag} {what}: backward error {bw}")
                        # layout and block_b only set the launch shape;
                        # two launches give the same bits
                        for layout, bb in (("transposed", 64), ("batch", 1),
                                           ("batch", 64)):
                            for r in routes:
                                u_l = tk.tridiag_solve_kernel(
                                    *args[:3], bb, layout, plan=r)
                                if not torch.equal(u_l, k[0]):
                                    raise AssertionError(
                                        f"{tag}: {r} route, layout {layout}"
                                        f" block_b {bb} changed the result")
                del d64, e64, F64, w64, k, ks, p, q, args
            log(f"phase 13 {kind} n={n}: every B, batched and shared bands, "
                f"f32 and f64, u and the three band gradients within the "
                f"gates and equal to the plain version's bits on the "
                f"{' and '.join(routes)} route(s); every layout and launch "
                f"equal bit for bit")
            torch.cuda.empty_cache()
    log(f"phase 13 kernel vs plain: {time.perf_counter() - t0:.1f} s "
        f"(max abs err at n={N_1D + 1} f32 vs f64 plain: {max_abs:.3e})")

    # -- phase 14: the main path, BASELINE.json config 2
    mesh = FEMesh.line(N_1D, dtype=f32)
    if mesh.device.type != dev.type:
        raise AssertionError(f"the mesh factory put the mesh on "
                             f"{mesh.device}")
    g0 = torch.Generator(device=dev).manual_seed(0)
    x = mesh.nodes[:, 0]
    k_true = 1.2 + 0.6 * torch.rand(BATCH_1D, N_1D, generator=g0, device=dev)
    kk = 1.0 + (torch.arange(BATCH_1D, device=dev) % 4)
    f = torch.sin(kk[:, None] * math.pi * x) + 1.5
    for key in tk.launches:
        tk.launches[key] = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        u_data = solve_poisson_batched(mesh, k_true, f,
                                       method="tridiag_pallas")
    kappa, hist = recover_kappa_field(mesh, f, u_data, adam_steps=STEPS_1D,
                                      lr=LR_1D, method="tridiag_pallas")
    torch.cuda.synchronize()
    main_path = dict(tk.launches)
    h0, h1 = float(hist[0]), float(hist[-1])
    log(f"phase 14 recover_kappa_field: n={N_1D} B={BATCH_1D} "
        f"{STEPS_1D} Adam steps lr={LR_1D}: loss {h0:.6e} -> {h1:.6e} "
        f"({h0 / h1:.1f}x) ({time.perf_counter() - t0:.2f} s with u_data)")
    log(f"1D facade main-path launches: {main_path}")
    # B = 1024 is below WARP_MIN_BATCH: the plan's route is the block route
    if main_path != {"pcr": 0, "pcr_block": 1 + 2 * STEPS_1D}:
        raise AssertionError(f"K2 launches {main_path}: the main path runs "
                             f"{1 + 2 * STEPS_1D} on the block route")
    if kappa.shape != (BATCH_1D, N_1D) or not bool(
            torch.isfinite(kappa).all()):
        raise AssertionError("recover_kappa_field's kappa is not finite of "
                             f"shape {(BATCH_1D, N_1D)}")
    if not h1 < 1e-3 * h0:
        raise AssertionError("the misfit fell less than 1e3x")

    # recover_kappa_scalar, f64, bench_full.py's gate (the PCR oracle route)
    m30 = FEMesh.line(30, dtype=f64)
    x30 = m30.nodes[:, 0]
    fB = (torch.sin(math.pi * x30) + 1.0).expand(4, m30.n_nodes)
    kt = torch.tensor([0.7, 1.3, 2.0, 2.9], dtype=f64, device=dev)
    ud = solve_poisson_batched(m30, kt, fB, kappa_batched=True)
    kr, _ = recover_kappa_scalar(m30, fB, ud, adam_steps=100,
                                 newton_steps=8)
    err = float((kr - kt).abs().max())
    log(f"phase 14 recover_kappa_scalar f64 n=30 B=4: max kappa error "
        f"{err:.3e}")
    if not err < 1e-6:
        raise AssertionError(f"scalar kappa error {err:.3e}")

    # examples/poisson_1d_demo.py's three stages, f64
    m20 = FEMesh.line(20, dtype=f64)
    x20 = m20.nodes[:, 0]
    u_fem = solve_poisson(m20, 1.0, torch.ones_like(x20))
    e1 = float((u_fem - x20 * (1.0 - x20) / 2.0).abs().max())
    model = NeuralPDE(m20, hidden_dim=64, n_layers=3,
                      generator=torch.Generator().manual_seed(42))
    t0 = time.perf_counter()
    losses = model.train_pde(torch.ones_like, n_epochs=3000, lr=1e-3,
                             verbose=False)
    t_nn = time.perf_counter() - t0
    free = torch.as_tensor(m20.free_nodes(), device=dev)
    with torch.no_grad():
        u_nn = model()
    e2 = float((u_nn[free] - u_fem[free]).abs().max()
               / u_fem[free].abs().max())
    f30 = torch.sin(math.pi * x30) + 1.0
    u30 = solve_poisson(m30, 2.0, f30)
    k = torch.tensor(1.0, dtype=f64, device=dev, requires_grad=True)
    opt = torch.optim.Adam([k], lr=0.1, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(200):
        opt.zero_grad()
        ((solve_poisson(m30, k.abs(), f30) - u30) ** 2).mean().backward()
        opt.step()
    e3 = abs(float(k.detach().abs()) - 2.0)
    log(f"phase 14 demo: FEM max error {e1:.2e}; NeuralPDE 3000 epochs "
        f"({t_nn:.1f} s) final loss {losses[-1]:.2e}, max relative error on "
        f"free nodes {e2:.3e}; recovered kappa "
        f"{float(k.detach().abs()):.6f}")
    if not (e1 <= 1e-13 and e2 < 0.05 and e3 < 1e-4):
        raise AssertionError(f"demo gates: {e1:.2e} {e2:.3e} {e3:.2e}")
    fb = torch.randn(5, m20.n_nodes, generator=gen, dtype=f64, device=dev)
    u_k = DifferentiableFESolver(m20, 1.7, method="tridiag_pallas")(fb)
    u_d = DifferentiableFESolver(m20, 1.7, method="dense")(fb)
    e4 = rel_err(u_k, u_d)
    log(f"phase 14 DifferentiableFESolver tridiag_pallas vs dense, f64: "
        f"rel err {e4:.2e}")
    if not e4 <= 1e-10:
        raise AssertionError(f"DifferentiableFESolver disagrees: {e4:.2e}")
    del kappa, hist, model
    torch.cuda.empty_cache()

    # -- phase 15: the κ gradient through the route, K2 forward and adjoint
    def kappa_grad(method, dt):
        m = FEMesh.line(N_1D, dtype=dt)
        ke = torch.ones(BATCH_1D, N_1D, dtype=dt, device=dev,
                        requires_grad=True)
        u = solve_poisson_batched(m, ke, f.to(dt), method=method)
        ((u - u_data.to(dt)) ** 2).mean().backward()
        return ke.grad

    ek, ep = check_rule("K2 gradient", kappa_grad("tridiag_pallas", f32),
                        kappa_grad("tridiag", f32), kappa_grad("tridiag", f64),
                        "phase 15 κ gradient")
    e64 = rel_err(kappa_grad("tridiag_pallas", f64),
                  kappa_grad("tridiag", f64))
    log(f"phase 15 κ gradient of the batched MSE through K2 (forward + "
        f"adjoint): f32 rel err vs f64 plain {ek:.3e} (f32 plain {ep:.3e}); "
        f"f64 rel err vs f64 plain {e64:.3e}")
    if not e64 <= 1e-10:
        raise AssertionError(f"f64 κ gradient disagrees: {e64:.3e}")

    # -- phase 16: timing at n = 129, f32, at the main path's B = 1024 and
    # at scripts/probe_tridiag.py's 65 536
    n = N_1D + 1
    ms, k2 = {}, {}
    for B in (BATCH_1D, BATCH_K2):
        dB, eB = k2_bands(torch, "fem", n, B, gen, dev)
        dB, eB = dB.float(), eB.float()
        F0 = torch.randn(B, n, generator=gen, device=dev)

        def fwd_bwd(solve):
            def step(c):
                dd = dB.detach().requires_grad_()
                (gd,) = torch.autograd.grad(solve(dd, eB, c), dd,
                                            grad_outputs=c)
                return gd
            return step

        def solve(plan):
            return lambda dd, ee, c: tk.tridiag_solve_kernel(dd, ee, c,
                                                             plan=plan)

        ms[B] = {
            "fwd": timed_pair(lambda c: tk.tridiag_solve_kernel(dB, eB, c),
                              lambda c: ttri.tridiag_solve(dB, eB, c), F0,
                              4),
            "fwd_bwd": timed_pair(fwd_bwd(tk.tridiag_solve_kernel),
                                  fwd_bwd(ttri.tridiag_solve), F0, 4),
            "plain_device": device_ms(
                torch, lambda c: ttri.tridiag_solve(dB, eB, c), F0, 20),
        }
        # device time of a call (at B = 1024 the chain is host-bound), the
        # two routes in turns
        for route in ("warp", "block", "block", "warp"):
            key = "pcr_warp_kernel" if route == "warp" else "pcr_kernel"
            t = device_ms(torch, lambda c, r=route: solve(r)(dB, eB, c), F0,
                          20, key)
            ms[B][route] = min(ms[B].get(route, float("inf")), t)
        ms[B]["device"] = ms[B][tk.k2_plan(n, f32, B)]
        lb = min(B, BATCH_LIB)
        T = (torch.diag_embed(dB[:lb]) + torch.diag_embed(eB[:lb], 1)
             + torch.diag_embed(eB[:lb], -1))
        F_lib = F0[:lb].contiguous()
        t_lib = timeit_chained_min(
            lambda c: torch.linalg.solve(T, c[..., None])[..., 0], F_lib)
        lib_device = device_ms(
            torch, lambda c: torch.linalg.solve(T, c[..., None])[..., 0],
            F_lib, 2)
        steps = math.ceil(math.log2(n))
        ops = B * n * (K2_OPS_PER_ROW_SWEEP * steps + 1)
        nbytes = (4 * n - 1) * B * 4
        b_ms, b_by = bound(ops, nbytes)
        k2[B] = (ops, nbytes, lib_device * B / lb)
        for name, what in (("fwd", "forward solve"),
                           ("fwd_bwd", "forward + backward (2 K2 launches)")):
            best = ms[B][name]
            log(f"phase 16 K2 {what}: kernel {best['kernel']:.4f} ms, plain "
                f"{best['plain']:.4f} ms (n={n}, B={B}, f32) [{card}]")
        log(f"phase 16 K2 forward solve on the device (profiler, kernel "
            f"time of a call): warp route {ms[B]['warp']:.4f} ms, block "
            f"route (first design) {ms[B]['block']:.4f} ms, plain "
            f"{ms[B]['plain_device']:.4f} ms, torch.linalg.solve "
            f"{lib_device:.4f} ms at B={lb} (n={n}, B={B}) [{card}]")
        log(f"phase 16 K2 bound at B={B} {b_ms:.4f} ms ({b_by}); kernel "
            f"{nbytes / ms[B]['device'] / 1e6:.1f} GB/s of the "
            f"{PEAK_BYTES / 1e12:.2f} TB/s peak; torch.linalg.solve on the "
            f"densified systems {t_lib:.4f} ms at B={lb}"
            + (f", {t_lib * B / lb:.4f} ms scaled to B={B}" if lb < B
               else "") + f" [{card}]")
        del T, dB, eB, F0, F_lib
        torch.cuda.empty_cache()

    # both routes' kernel time a call over the batch, in turns
    n = N_1D + 1
    for B in K2_SWEEP_BS:
        dB, eB = k2_bands(torch, "fem", n, B, gen, dev)
        dB, eB = dB.float(), eB.float()
        F0 = torch.randn(B, n, generator=gen, device=dev)
        t = {}
        for route in ("warp", "block", "block", "warp"):
            key = "pcr_warp_kernel" if route == "warp" else "pcr_kernel"
            ms_r = device_ms(torch, lambda c, r=route: (
                tk.tridiag_solve_kernel(dB, eB, c, plan=r)), F0, 20, key)
            t[route] = min(t.get(route, float("inf")), ms_r)
        log(f"phase 16 K2 kernel time a call at n={n}, B={B}: warp route "
            f"{t['warp']:.4f} ms, block route {t['block']:.4f} ms [{card}]")
        del dB, eB, F0

    for B in (BATCH_1D, BATCH_K2):
        mB = FEMesh.line(N_1D, dtype=f32)
        fb = f[torch.arange(B, device=dev) % BATCH_1D]
        with torch.no_grad():
            ub = solve_poisson_batched(
                mB, k_true[torch.arange(B, device=dev) % BATCH_1D], fb,
                method="tridiag_pallas")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recover_kappa_field(mB, fb, ub, adam_steps=STEPS_1D, lr=LR_1D,
                                method="tridiag_pallas")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        log(f"phase 16 recover_kappa_field host time, {STEPS_1D} steps, "
            f"B={B}: " + ", ".join(f"{t:.4f}" for t in times)
            + f" s; {B * STEPS_1D / min(times):.6e} grad-solves/s [{card}]")
    profile_split(
        torch, lambda: recover_kappa_field(
            mesh, f, u_data, adam_steps=STEPS_1D, lr=LR_1D,
            method="tridiag_pallas"),
        "phase 16", card, what=f"recover_kappa_field (B={BATCH_1D})")

    # the main path's shape: its 401 launches ran at B = 1024; the three
    # times are device times of a call
    log("phase 16 -Xptxas -v of K2's routes:")
    for line in ptxas_report(("15pcr_warp_kernel", "10pcr_kernel")):
        log(line)
    ops, nbytes, library_ms = k2[BATCH_1D]
    replaces = f"{JAX_K2}:80 (_pcr_pallas_padded), :161 (_pcr_pallas_T)"
    return [kernel_entry(name, K2_SOURCE, replaces, main_path[key], max_abs,
                         ms[BATCH_1D][route], ms[BATCH_1D]["plain_device"],
                         ops, nbytes, library_ms)
            for name, key, route in (("tridiag_pcr", "pcr", "warp"),
                                     ("tridiag_pcr_block", "pcr_block",
                                      "block"))]


N_PROD = 30             # the production demo's FEMesh.line(30)
BATCH_PROD = 262144      # its default batch
BATCH_BENCH = 2 ** 21    # bench_full.py's K7 row, probe_thomas.py's batch
BATCH_K5A = 2 ** 20      # bench_full.py's K5a row
BATCH_GATE = 4096        # the bench/probe gates' slice
FUSED_NS = (2, 13, 31, 129, 257)         # phase 17: K5a/K5b/K6 nodes
K7_NS = (2, 13, 31, 136)                 # 137 checks the route to K5a
FUSED_BIG = 2 ** 20      # phase 17's largest batch, for n <= 31
FUSED_BS = (7, 1000, FUSED_BIG)
K7_BODIES = ((1, 3), (2, 3), (3, 0), (3, 2), (3, 3))   # (version, refine)
K5_SWEEP_BS = (7, 256, 1000, 4096, 65536)   # phase 20: K5's routes by
K5_SWEEP_NS = (31, 33, 64, 96, 128)          # batch and n
K5_ROUTES = ("warp", "block")
K5_KEYS = {"warp": "fused_pcr_warp_kernel", "block": "fused_pcr_kernel"}
K6_ROUTES = ("reg", "block")
K6_KEYS = {"reg": "thomas_reg_kernel", "block": "thomas_kernel"}
K6_SWEEP_NS = (2, 13, 31, 32, 33, 64)           # phase 20: K6's routes by
K6_SWEEP_BS = (7, 1000, 65536, BATCH_BENCH)     # n and batch
FUSED_SOURCES = {"k5a": "difffe_tpu_torch/csrc/fused_grad_pcr.cu",
                 "k5b": "difffe_tpu_torch/csrc/fused_grad_pcr.cu",
                 "k6": "difffe_tpu_torch/csrc/fused_grad_thomas.cu",
                 "k7": "difffe_tpu_torch/csrc/fused_grad_mxu.cu"}
FUSED_REPLACES = {
    "k5a": "difffe_tpu/ops/pallas/fused_grad_kernel.py:123 (_fused_pallas)",
    "k5b": "difffe_tpu/ops/pallas/fused_grad_kernel.py:312 "
           "(_general_pallas)",
    "k6": "difffe_tpu/ops/pallas/fused_grad_thomas_kernel.py:149 "
          "(_thomas_pallas)",
    "k7": "difffe_tpu/ops/pallas/fused_grad_mxu_kernel.py:282 (_mxu_pallas)"}
FUSED_NAMES = {"k5a": "fused_pcr_scalar", "k5b": "fused_pcr_general",
               "k6": "fused_thomas", "k7": "fused_mxu"}


def fused_ops(name, n, version=2, refine=0):
    """Operations of one scenario's step, counted from the kernel sources
    (a division, an exp and a fused multiply-add count as one, two for the
    multiply-add): K5 per row 22 + 18 per sweep (K5a: assembly 8, sweeps
    14, the u/loss/adjoint seed 5, replay 4, λ 1, contraction 8) or 34 + 18
    per sweep (K5b: assembly 20, the gradient 7 more); K6 47 a row (the
    factorization and u substitution 23, back 2, loss and λ 10, λ back and
    the gradient 12); K7 2n² a product, 12 a row around them and 7 a row
    per refinement pass."""
    steps = max(1, math.ceil(math.log2(n)))
    if name == "k5a":
        return n * (22 + 18 * steps)
    if name == "k5b":
        return n * (34 + 18 * steps)
    if name == "k6":
        return 47 * n
    passes = refine if version == 3 else 0
    return 2 * (1 + passes) * 2 * n * n + 2 * passes * 7 * n + 12 * n + 3


def fused_bytes(name, n, store=4, shared_f=False, kappa_item=4):
    """Bytes one scenario's step must move: κ (log κ, or n − 1 element
    values) in, u_data and a streamed F in, loss and the gradient (1 or
    n − 1 values) out."""
    kap = kappa_item if name in ("k5a", "k7") else kappa_item * (n - 1)
    out = 4 + (4 if name in ("k5a", "k7") else 4 * (n - 1))
    return kap + n * store + (0 if shared_f else n * store) + out


def fused_plain(name, mesh, scale, version=2, refine=3, products="exact"):
    """The plain version of a fused step as a function of (κ, F, u_data)
    stored as the wrapper stores them; K7's with its products rounded as
    ``products`` says."""
    from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
    from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
    from difffe_tpu_torch.ops.kernels import fused_grad_thomas_kernel as k6

    if name == "k5a":
        cols = k5.scalar_columns(mesh)
        return lambda a, F, ud: k5._k5a_plain(a, F, ud, cols, scale)
    if name == "k7":
        cols, W = k5.scalar_columns(mesh), k7.mxu_inverse(mesh)
        return lambda a, F, ud: k7._k7_plain(a, F, ud, cols, W, scale,
                                             version, refine, products)
    cols, inv_h = k5.general_constants(mesh)
    pl = k5._k5b_plain if name == "k5b" else k6._k6_plain
    return lambda a, F, ud: pl(a, F, ud, cols, inv_h, scale)


def fused_kernel(name, mesh, scale, version=2, refine=3, block_lanes=None,
                 plan=None):
    """The public wrapper of a fused step as a function of (κ, F, u_data);
    bf16-stored planes pass through with ``operand_dtype`` bf16; K5, K6
    and K7 on ``plan``'s route where given."""
    from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
    from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
    from difffe_tpu_torch.ops.kernels import fused_grad_thomas_kernel as k6
    import torch

    def op(ud):
        return torch.bfloat16 if ud.dtype == torch.bfloat16 else None

    bl = {} if block_lanes is None else {"block_lanes": block_lanes}
    if name == "k5a":
        return lambda a, F, ud: k5.fused_kappa_mse_step(
            mesh, a, F, ud, scale=scale, plan=plan, **bl)
    if name == "k7":
        return lambda a, F, ud: k7.fused_kappa_mse_step_mxu(
            mesh, a, F, ud, scale=scale, operand_dtype=op(ud),
            version=version, refine=refine, plan=plan, **bl)
    if name == "k5b":
        return lambda a, F, ud: k5.fused_kappa_mse_step_general_pcr(
            mesh, a, F, ud, scale=scale, operand_dtype=op(ud), plan=plan,
            **bl)
    return lambda a, F, ud: k6.fused_kappa_mse_step_general(
        mesh, a, F, ud, scale=scale, operand_dtype=op(ud), plan=plan, **bl)


def fused_launches():
    from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
    from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
    from difffe_tpu_torch.ops.kernels import fused_grad_thomas_kernel as k6

    return {**k5.launches, **k6.launches, **k7.launches}


def reset_fused_launches():
    from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
    from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
    from difffe_tpu_torch.ops.kernels import fused_grad_thomas_kernel as k6

    for mod in (k5, k6, k7):
        for key in mod.launches:
            mod.launches[key] = 0
    for routes in (k5.route_launches, k6.route_launches):
        for key in routes:
            routes[key] = 0


def fused_operands(torch, dev, n, B, gen, bc, shared_f, bf16):
    """f32 and f64 meshes and f64 operands: log κ, per-element κ, the load
    (shared (n,) or (B, n)) of a perturbed sin(πx) + 1 and observations
    of a random κ field; ``bf16`` marks the planes to store half-width."""
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.assembly import assemble_load
    from difffe_tpu_torch.solver import solve_poisson_batched

    f64 = dict(dtype=torch.float64, device=dev)
    meshes = [FEMesh.line(n - 1, bc_left=bc[0], bc_right=bc[1], dtype=dt,
                          device=dev) for dt in (torch.float32, torch.float64)]
    x = meshes[1].nodes[:, 0]
    f = (torch.sin(math.pi * x) + 1.0) * (
        1.0 + 0.2 * torch.rand(B, 1, generator=gen, **f64))
    with torch.no_grad():
        ud = solve_poisson_batched(
            meshes[1], 1.0 + torch.rand(B, n - 1, generator=gen, **f64), f,
            method="tridiag")
    F = assemble_load(meshes[1], f)
    F = F[0] if shared_f else F
    lk = 0.3 * torch.randn(B, generator=gen, **f64)
    ke = 1.0 + torch.rand(B, n - 1, generator=gen, **f64)
    return meshes, lk, ke, F, ud


def k7_products(n, version, plan=None):
    """The products of K7's float32 route at n nodes (``plan`` or the
    one k7_plan picks): the "tc" route's tensor-core rounding, else
    exact."""
    import torch
    from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7

    route = plan or k7.k7_plan(torch.float32, n, version)
    return k7.TC_PRODUCTS[version] if route == "tc" else "exact"


def check_fused(torch, name, meshes, lk, ke, F, ud, bf16, version=2,
                refine=3, plan=None):
    """Phase 17's comparison of one case (K5, K6 and K7 on ``plan``'s route;
    K7 against the plain version with that route's products; on the "tc"
    route also two launches bit for bit and a logged line with the error
    against the exact f64 plain version beside the rule's, elsewhere also
    the f64 kernel); returns the f32 kernel's max abs error on the
    gradient against the exact f64 plain version and the f32 and f64
    kernels' outputs (None for the f64 ones on the "tc" route)."""
    from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7

    B, n = ud.shape
    scale = 2.0 / (B * n)
    kap = lk if name in ("k5a", "k7") else ke
    m32, m64 = meshes
    products = k7_products(n, version, plan) if name == "k7" else "exact"
    # the stored planes, quantized once from the f32 data
    F32, ud32 = F.float(), ud.float()
    if bf16:
        ud32 = ud32.bfloat16()
        F32 = F32 if F.ndim == 1 else F32.bfloat16()

    def wide(t, dt):
        return t if t.dtype == torch.bfloat16 else t.to(dt)

    args32 = (kap.float(), F32, ud32)
    kern = fused_kernel(name, m32, scale, version, refine, plan=plan)
    k = kern(*args32)
    p32 = fused_plain(name, m32, scale, version, refine, products)(*args32)
    p64 = fused_plain(name, m64, scale, version, refine, products)(
        kap, wide(F32, torch.float64), wide(ud32, torch.float64))
    what = (f"phase 17 {name}{'' if plan is None else ' ' + plan} n={n} "
            f"B={B} F={'shared' if F.ndim == 1 else 'plane'} "
            f"{'bf16' if bf16 else 'f32'} v{version} r{refine}")
    errs = [check_rule(name, a, b, c, f"{what} {label}",
                       k7.rule_slack(products, n))[0]
            for label, a, b, c in zip(("loss", "grad"), k, p32, p64)]
    if products != "exact":
        if not all(torch.equal(a, b) for a, b in zip(kern(*args32), k)):
            raise AssertionError(f"{what}: two launches differ")
        p64 = fused_plain(name, m64, scale, version, refine)(
            kap, wide(F32, torch.float64), wide(ud32, torch.float64))
        exact = [rel_err(a, c) for a, c in zip(k, p64)]
        log(f"{what}: rel err loss, grad vs the f64 plain version with "
            f"{products} products {errs[0]:.3e}, {errs[1]:.3e}; vs the "
            f"exact f64 plain version {exact[0]:.3e}, {exact[1]:.3e}")
    else:
        k64 = fused_kernel(name, m64, scale, version, refine,
                           plan=plan if name in ("k5a", "k5b") else None)(
            kap, wide(F32, torch.float64), wide(ud32, torch.float64))
        for label, a, c in zip(("loss", "grad"), k64, p64):
            e = rel_err(a, c)
            if not e <= 1e-10:
                raise AssertionError(f"{what} {label} f64: rel err {e:.3e}")
        return float((k[1].double() - p64[1]).abs().max()), k, k64
    return float((k[1].double() - p64[1]).abs().max()), k, None


def fused_gate(torch, name, mesh, grad, kap, f, ud_q, what, limit):
    """The bench/probe gate: the step's gradient (scale 2/n) on the first
    BATCH_GATE scenarios against autograd through the 'tridiag' route fed
    the same (quantized) observations; raises above ``limit`` (None: only
    logs).  Returns the relative error."""
    from difffe_tpu_torch.solver import solve_poisson_batched

    sl = slice(0, BATCH_GATE)
    k = kap[sl].detach().clone().requires_grad_()
    kap_arg = torch.exp(k) if name in ("k5a", "k7") else k
    u = solve_poisson_batched(mesh, kap_arg, f[sl], method="tridiag",
                              kappa_batched=True)
    ((u - ud_q[sl].float()) ** 2).mean(dim=-1).sum().backward()
    gate = rel_err(grad[sl], k.grad)
    log(f"phase 19 {what}: gradient gate rel={gate:.3e} "
        + ("(not gated)" if limit is None else f"(limit {limit})"))
    if limit is not None and not gate <= limit:
        raise AssertionError(f"{what}: gate {gate:.3e} > {limit}")
    return gate


def ptxas_report(names):
    """One line per compiled kernel whose mangled name holds one of
    ``names``: its registers and spills, from the build's -Xptxas -v
    log."""
    from difffe_tpu_torch.ops.kernels import _build

    lines = _build.library_path().with_suffix(".log").read_text().splitlines()
    current, stats = None, {}
    for line in lines:
        if "Compiling entry function" in line:
            current = line.split("'")[1]
        elif current and any(k in current for k in names):
            if "spill" in line or "Used" in line:
                stats.setdefault(current, []).append(
                    line.split(":", 1)[-1].strip())
    mangled = list(stats)
    try:        # demangled names where binutils' c++filt is installed
        shown = subprocess.run(["c++filt"], input="\n".join(mangled),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        shown = [s.split(">(")[0].replace("(anonymous namespace)::", "")
                 + ">" for s in shown]
    except (OSError, subprocess.CalledProcessError):
        shown = mangled
    return [f"  {name}: {'; '.join(stats[m])}"
            for name, m in zip(shown, mangled)]


@functools.cache
def _sass_bodies():
    """The built library's SASS, one text a kernel, and the kernels'
    demangled names (``cuobjdump -sass`` once a run)."""
    import re

    from difffe_tpu_torch.ops.kernels import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    bodies = re.split(r"\n\s*Function : ", text)[1:]
    shown = subprocess.run(
        ["c++filt"], input="\n".join(b.split("\n", 1)[0].strip()
                                     for b in bodies),
        capture_output=True, text=True, check=True).stdout.splitlines()
    return bodies, shown


def sass_report(names):
    """One line per compiled kernel whose demangled name holds one of
    ``names``: its static SASS instruction count, how many of them are
    predicated, and its most frequent opcodes, from ``cuobjdump -sass``
    of the built library (a body unrolled over its rows runs each of
    these once a tile).  Without cuobjdump the lines say so."""
    import collections
    import re

    try:
        bodies, shown = _sass_bodies()
    except (OSError, subprocess.CalledProcessError) as exc:
        return [f"  SASS not measured ({exc})"]
    lines = []
    for body, name in zip(bodies, shown):
        name = name.replace("(anonymous namespace)::", "")
        if not any(k in name for k in names):
            continue
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]+)", body)
        ops = collections.Counter(op.split(".")[0] for _, op in ins)
        lines.append(f"  {name[:name.rfind('(')]}: {len(ins)} SASS "
                     f"instructions, {sum(1 for p, _ in ins if p)} "
                     f"predicated; " + ", ".join(
                         f"{k} {v}" for k, v in ops.most_common(10)))
    return lines


def k7_bound(route, n, B, version, refine, store=4, shared_f=False):
    """(operations, bytes, least seconds of the operations, rate label) of
    K7's step on ``route`` at n nodes and B scenarios, by fused_ops'
    count: 2n² a product, 2 (1 + passes) products, 12n + 3 row operations
    and 7 float64 operations a row and refinement pass.  The float64
    residual runs on the float64 pipes (34 TFLOP/s) beside the f32 pipes.
    The "fma" route does its products and row work on the f32 pipes, one
    after the other; the "tc" route its products on the tensor cores (TF32
    495 TFLOP/s, three passes for 3xTF32; bf16 989) beside the row work,
    so its operations take the largest of the three times."""
    from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7

    passes = refine if version == 3 else 0
    prod = 2 * (1 + passes) * 2 * n * n
    row = 12 * n + 3
    resid = 2 * passes * 7 * n
    nbytes = B * fused_bytes("k7", n, store, shared_f)
    ops = B * (prod + row + resid)
    t_f64 = B * resid / PEAK_F64
    if route == "fma":
        return (ops, nbytes, max(B * (prod + row) / PEAK_FLOPS, t_f64),
                "f32 67 TFLOP/s, float64 34")
    rate, label, mult = {"tf32x3": (PEAK_TF32, "3xTF32 at 495 TFLOP/s", 3),
                         "bf16": (PEAK_BF16, "bf16 989 TFLOP/s", 1)}[
                             k7.TC_PRODUCTS[version]]
    t = max(B * mult * prod / rate, B * row / PEAK_FLOPS, t_f64)
    return ops, nbytes, t, f"{label} beside f32 67, float64 34"


def device_ms(torch, fn, x0, length, key=None, launched=None,
              required=True):
    """Device time in ms of one call of ``fn(x0)``, from torch.profiler
    over ``length`` calls recorded after as many traced but unrecorded
    ones (the trace's first launches can go missing otherwise): with
    ``key``, the mean time of a launch of the kernels whose name holds it,
    and each call must launch one; without, every kernel's time over
    ``length``.  Kernel time alone, without the gaps a host-bound chain
    leaves between launches, so a kernel and its plain version are timed
    alike.  ``launched()``, where given, is the wrapper's count of the
    keyed kernel's launches: each call must add one to it, so a trace
    that misses launches is told from a call that did not make them.
    Where ten traces miss launches (without ``key``: hold no kernel) it
    raises, or with ``required`` false returns None (the caller prints
    the time as not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn(x0)
    torch.cuda.synchronize()
    # a trace can still drop a launch: record again (ten tries) until
    # it holds exactly one a call
    for _ in range(10):
        before = None if launched is None else launched()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(length):
                    fn(x0)
                torch.cuda.synchronize()
                prof.step()
        if launched is not None and launched() - before != 2 * length:
            raise AssertionError(f"{2 * length} calls launched "
                                 f"{launched() - before} of {key}")
        cuda = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows = [e for e in cuda if key is None or key in e.key]
        total = sum(e.self_device_time_total for e in rows) / 1e3
        if key is None:
            if rows:
                return total / length
            log(f"device_ms: the trace of {length} calls holds no kernel; "
                f"recording again")
            continue
        count = sum(e.count for e in rows)
        if count == length:
            return total / count
        log(f"device_ms: profiled {count} launches of {key} in {length} "
            f"calls (the trace's kernels: "
            f"{[(e.key[:60], e.count) for e in cuda]}); recording again")
    if required:
        raise AssertionError(
            "profiled no kernel" if key is None else
            f"profiled {count} launches of {key} in {length} calls")
    log(f"device_ms: no trace held the {length} launches of {key}: not "
        f"measured")
    return None


def launch_shape(torch, fn, x0, key, length=20):
    """The grid, the blocks an SM and the registers a thread of the launch
    of the kernel whose name holds ``key`` in ``fn(x0)``, from the
    profiler's trace (CUPTI's kernel record); None where ten traces of
    ``length`` calls hold no such launch (it then logs the kernel records
    of the last).  A persistent grid's blocks an SM are those the
    occupancy API gave it.  As in ``device_ms``, a traced but unrecorded
    step comes first, and a trace can miss launches: it records again."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    fn(x0)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(length):
                    fn(x0)
                torch.cuda.synchronize()
                prof.step()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            trace = json.loads(path.read_text())
        kernels = [e for e in trace.get("traceEvents", [])
                   if str(e.get("cat", "")).lower() == "kernel"]
        for e in kernels:
            args = e.get("args", {})
            if key in e.get("name", "") and "grid" in args:
                grid = math.prod(args["grid"])
                return grid, grid / sms, args.get("registers per thread")
    seen = [(e.get("name", "")[:60], sorted(e.get("args", {})))
            for e in kernels[:3]]
    log(f"launch_shape: no record of {key} with a grid among {seen}")
    return None


def timed_turns(fns, x0, length, order):
    """Best chained ms per call of each function of ``fns`` (name ->
    function), timed in ``order``."""
    from difffe_tpu_torch.utils.profiling import timeit_chained

    best = {k: float("inf") for k in fns}
    for which in order:
        t = timeit_chained(fns[which], x0, length=length, repeats=2)
        best[which] = min(best[which], t.min_s * 1e3)
    return best


def run_fused_1d(torch, dev, card):
    """Phases 17-20; returns the K5a, K5b, K6 and K7 entries of the kernels
    line."""
    from difffe_tpu_torch import production
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.assembly import assemble_load
    from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
    from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
    from difffe_tpu_torch.ops.kernels import fused_grad_thomas_kernel as k6
    from difffe_tpu_torch.solver import solve_poisson_batched

    gen = torch.Generator(device=dev).manual_seed(17)

    # -- phase 17: every new kernel against its plain version; K7 on both
    # routes where n <= 32, K5 on both where n <= 128 (the two K5 routes'
    # row values equal bit for bit), K6 on both where n <= 32 (the two
    # routes' outputs equal bit for bit)
    t0 = time.perf_counter()
    max_abs = {k: 0.0 for k in (*FUSED_SOURCES, "k7_fma")}
    for name in ("k5a", "k5b", "k6", "k7"):
        cases = 0
        for n in (K7_NS if name == "k7" else FUSED_NS):
            routes = [None]
            if name == "k7":
                routes = (["tc", "fma"] if n <= k7.TC_MAX_NODES else ["fma"])
            elif name in ("k5a", "k5b"):
                routes = (K5_ROUTES if n <= k5.K5_WARP_MAX_ROWS
                          else ["block"])
            elif name == "k6":
                routes = (K6_ROUTES if n <= k6.K6_REG_MAX_NODES
                          else ["block"])
            for B in (b for b in FUSED_BS if b < FUSED_BIG or n <= 31):
                combos = [(bc, shared_f, bf16)
                          for bc in ((0.0, 0.0), (0.3, -0.2))
                          for shared_f in (False, True)
                          for bf16 in ((False,) if name == "k5a"
                                       else (False, True))]
                if B == FUSED_BIG:    # two of them at the largest batch,
                    # and for K7 the main path's streamed f32 planes too
                    combos = ([c for c in combos if c[1] != c[2]][:2]
                              + combos[:1] * (name == "k7"))
                for bc, shared_f, bf16 in combos:
                    meshes, lk, ke, F, ud = fused_operands(
                        torch, dev, n, B, gen, bc, shared_f, bf16)
                    bodies = ((2, 3),)
                    if name == "k7":
                        bodies = (K7_BODIES if B < FUSED_BIG
                                  else ((2, 3), (3, 2)))
                    for version, refine in bodies:
                        outs = []
                        for plan in routes:
                            e, *out = check_fused(torch, name, meshes, lk,
                                                  ke, F, ud, bf16, version,
                                                  refine, plan)
                            outs.append(out)
                            cases += 1
                            if n == N_PROD + 1:   # by route, the
                                # planned one's under the kernel's name
                                key = "k7_fma" if plan == "fma" else name
                                planned = {
                                    "k5a": k5.k5_plan, "k5b": k5.k5_plan,
                                    "k6": k6.k6_plan}.get(name)
                                if planned and plan != planned(
                                        n, torch.float32):
                                    key = f"{name}_{plan}"
                                max_abs[key] = max(max_abs.get(key, 0.0), e)
                        # K5b's gradient (no sum) is the same on both
                        # routes; the sums, checked by the rule above,
                        # take another order on each.  K6's routes make
                        # every operation alike: loss and gradient agree
                        if name in ("k5b", "k6") and len(outs) == 2:
                            for ka, kb in zip(*outs):
                                pairs = zip(ka, kb) if name == "k6" else \
                                    [(ka[1], kb[1])]
                                for a, b in pairs:
                                    if not torch.equal(a, b):
                                        raise AssertionError(
                                            f"phase 17 {name} n={n} B={B}: "
                                            f"the routes' outputs differ")
                    del meshes, lk, ke, F, ud
            torch.cuda.empty_cache()
        log(f"phase 17 {name}: {cases} cases within the gates (f32 by the "
            f"rule of phase 7, f64 within 1e-10"
            + ("; n <= 32 on the tc route against the plain version with its "
               "products and on the fma route; two tc launches equal bit "
               "for bit" if name == "k7" else "")
            + (f"; n <= {k5.K5_WARP_MAX_ROWS} on the warp and block routes"
               + (", their f32 and f64 gradients equal bit for bit"
                  if name == "k5b" else "")
               if name in ("k5a", "k5b") else "")
            + (f"; n <= {k6.K6_REG_MAX_NODES} on the reg and block routes, "
               f"their f32 losses and gradients equal bit for bit"
               if name == "k6" else "") + ")")
    reset_fused_launches()
    m137, lk, _, F, ud = fused_operands(torch, dev, 137, 64, gen, (0.0, 0.0),
                                        False, False)
    fused_kernel("k7", m137[0], 1.0, 3, 2)(lk.float(), F.float(), ud.float())
    routed = fused_launches()
    log(f"phase 17 K7 at n=137 routes to K5a: launches {routed}")
    if routed["k5a"] != 1 or routed["k7"] or routed["k7_fma"]:
        raise AssertionError(f"the n > 136 route launched {routed}")
    planned = k5.k5_plan(N_PROD + 1, torch.float32)
    other = "block" if planned == "warp" else "warp"
    log(f"phase 17 K5's f32 max abs error of the gradient at n={N_PROD + 1} "
        f"against the f64 plain version, by route: " + "; ".join(
            f"{name} {planned} (planned; the kernels line's) "
            f"{max_abs[name]:.3e}, {other} {max_abs[name + '_' + other]:.3e}"
            for name in ("k5a", "k5b"))
        + f"; k6 reg (planned) {max_abs['k6']:.3e}, block "
        f"{max_abs['k6_block']:.3e}")
    log(f"phase 17 kernel vs plain: {time.perf_counter() - t0:.1f} s")

    # -- phase 18: the main path, the production loop at its defaults
    mesh = production.production_mesh()
    if mesh.device.type != dev.type:
        raise AssertionError(f"production_mesh() put the mesh on "
                             f"{mesh.device}")
    g0 = torch.Generator(device=dev).manual_seed(0)
    k_true = 1.0 + 2.0 * torch.rand(BATCH_PROD, generator=g0, device=dev)
    F, u_data = production.production_data(mesh, k_true)
    reset_fused_launches()
    t0 = time.perf_counter()
    lk, losses = production.sgd_loop(mesh, F, u_data)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    main_path = fused_launches()
    hist = [float(v) for v in losses]
    err = float((torch.exp(lk) - k_true).abs().max())
    log(f"phase 18 production loop: B={BATCH_PROD} {production.STEPS} steps "
        f"lr={production.LR}: loss {hist[0]:.6e} {hist[1]:.6e} "
        f"{hist[2]:.6e} ... {hist[-3]:.6e} {hist[-2]:.6e} {hist[-1]:.6e} "
        f"({hist[0] / hist[-1]:.1f}x); max |kappa - kappa_true| "
        f"{err:.3e} ({t_loop:.3f} s with the first-call set-up)")
    log(f"fused 1D main-path launches: {main_path}")
    if main_path != {"k5a": 0, "k5b": 0, "k6": 0, "k7": production.STEPS,
                     "k7_fma": 0}:
        raise AssertionError(f"main-path launches {main_path}: every step "
                             f"on K7's tc route expected")
    if not hist[-1] * 1e3 <= hist[0]:
        raise AssertionError("the loss fell less than 1e3x")
    plain_step = fused_plain("k7", mesh, 2.0 / mesh.n_nodes)
    lk_p, losses_p = production.sgd_loop(
        mesh, F, u_data, step=lambda m, a, F_, ud_, **kw: plain_step(
            a, F_, ud_))
    dk = rel_err(torch.exp(lk), torch.exp(lk_p))
    dl = float(((losses.double() - losses_p.double()).abs()
                / losses_p.double().abs()).max())
    log(f"phase 18 against the loop on the plain version: final kappa rel "
        f"err {dk:.3e}, mean loss of each step rel err at most {dl:.3e} "
        f"(plain loss {float(losses_p[0]):.6e} -> "
        f"{float(losses_p[-1]):.6e})")
    if not dk <= 1e-3:
        raise AssertionError(f"kappa differs from the plain loop: {dk:.3e}")
    if not dl <= 1e-3:
        raise AssertionError(f"a step's loss differs from the plain loop's: "
                             f"{dl:.3e}")

    # -- phase 19: the other workloads, gated
    n = N_PROD + 1
    x = mesh.nodes[:, 0]
    fv = torch.sin(math.pi * x) + 1.0
    Fs = assemble_load(mesh, fv)
    gb = torch.Generator(device=dev).manual_seed(19)
    kB = 1.0 + 2.0 * torch.rand(BATCH_BENCH, generator=gb, device=dev)
    fB = fv.expand(BATCH_BENCH, n)
    with torch.no_grad():
        udB = solve_poisson_batched(mesh, kB, fB, method="tridiag",
                                    kappa_batched=True)
    scale = 2.0 / n
    work = {}
    # bench_full.py's K7 row: v3 refine 2, bf16 u_data, shared F
    ud_q = udB.bfloat16()
    lk0 = torch.zeros(BATCH_BENCH, device=dev)
    work["k7_bench"] = (fused_kernel("k7", mesh, scale, 3, 2, 8192),
                        fused_plain("k7", mesh, scale, 3, 2), lk0, Fs, ud_q)
    # bench_full.py's K5a row: B = 2^20, streamed F
    F1 = assemble_load(mesh, fB[:BATCH_K5A])
    work["k5a"] = (fused_kernel("k5a", mesh, scale, block_lanes=512),
                   fused_plain("k5a", mesh, scale), lk0[:BATCH_K5A], F1,
                   udB[:BATCH_K5A])
    # probe_thomas.py: per-element κ, shared F, block_lanes 512
    ke_true = 1.0 + torch.rand(BATCH_BENCH, N_PROD, generator=gb, device=dev)
    with torch.no_grad():
        udE = solve_poisson_batched(mesh, ke_true, fB, method="tridiag")
    ke0 = 1.0 + 0.3 * torch.rand(BATCH_BENCH, N_PROD, generator=gb,
                                 device=dev)
    for name in ("k5b", "k6"):
        for store in ("f32", "bf16"):
            ud_s = udE if store == "f32" else udE.bfloat16()
            work[f"{name}_{store}"] = (
                fused_kernel(name, mesh, scale, block_lanes=512),
                fused_plain(name, mesh, scale), ke0, Fs, ud_s)
    # K7's other bodies on the tc route with f32 storage (gate 1e-4)
    gates = {f"k7_v{v}r{r}_f32": (fused_kernel("k7", mesh, scale, v, r),
                                  None, lk0, Fs, udB)
             for v, r in ((1, 0), (2, 0), (3, 3))}
    for what, (kern, _, kap, F_, ud_) in {**work, **gates}.items():
        name = what.split("_")[0]
        reset_fused_launches()
        lp, gk = kern(kap, F_, ud_)
        torch.cuda.synchronize()
        if fused_launches()[name] != 1 or fused_launches()["k7_fma"]:
            raise AssertionError(f"{what}: launches {fused_launches()}")
        label = f"{what} B={kap.shape[0]}"
        if name in ("k5a", "k5b", "k6"):    # on the route the plan picks
            mod = k6 if name == "k6" else k5
            route = (k6.k6_plan if name == "k6" else k5.k5_plan)(
                n, torch.float32)
            if mod.route_launches[route] != 1:
                raise AssertionError(f"{what}: {mod.route_launches}, the "
                                     f"{route} route planned")
            label += f" ({route} route)"
        if not bool(torch.isfinite(gk).all() and torch.isfinite(lp).all()):
            raise AssertionError(f"{what}: non-finite outputs")
        f_gate = fB if F_.ndim == 1 else fB[:F_.shape[0]]
        fused_gate(torch, name, mesh, gk, kap, f_gate, ud_, label,
                   1e-2 if ud_.dtype == torch.bfloat16 else GATE_TOL)
    # version 3's gradient error by refinement pass, f32 and bf16 storage:
    # the tc route (bf16 products; refine 3 with f32 storage is gated
    # above), and the plain version with one TF32 pass (the alternative
    # the design kept in reserve) on the gate's slice
    cols, W = k5.scalar_columns(mesh), k7.mxu_inverse(mesh)
    per_pass = {}
    sl = slice(0, BATCH_GATE)
    for store, ud_ in (("f32", udB), ("bf16", ud_q)):
        for r in range(4):
            _, gk = k7._launch_tc(lk0, Fs, ud_, cols, W, scale, 3, r)
            per_pass["bf16", store, r] = fused_gate(
                torch, "k7", mesh, gk, lk0, fB, ud_,
                f"k7 v3 tc route r{r} {store} u_data B={BATCH_BENCH}", None)
            _, gp = k7._k7_plain(lk0[sl], Fs, ud_[sl].float(), cols, W,
                                 scale, 3, r, "tf32")
            per_pass["tf32", store, r] = fused_gate(
                torch, "k7", mesh, gp, lk0[sl], fB[sl], ud_[sl],
                f"k7 v3 plain, one TF32 pass, r{r} {store} u_data "
                f"B={BATCH_GATE}", None)
    log("phase 19 K7 v3 gradient gate by refinement pass (r0..r3): "
        + "; ".join(f"{p} {st}: " + ", ".join(
            f"{per_pass[p, st, r]:.3e}" for r in range(4))
            for p in ("bf16", "tf32") for st in ("f32", "bf16")))
    del udE, ke_true, gates
    torch.cuda.empty_cache()

    # -- phase 20: timing, host time, profile, registers
    ms = {}
    for what, (kern, plain, kap, F_, ud_) in work.items():
        # chained: each step's κ (log κ for K5a/K7) is the last one's
        # minus 1e-3 times its gradient, so κ stays near its start
        name, B = what.split("_")[0], kap.shape[0]
        if name not in ("k5a", "k5b", "k6"):
            ms[what] = best = timed_pair(
                lambda a: a - 1e-3 * kern(a, F_, ud_)[1],
                lambda a: a - 1e-3 * plain(a, F_, ud_)[1], kap, 4)
            log(f"phase 20 {what}: kernel {best['kernel']:.4f} ms, plain "
                f"{best['plain']:.4f} ms (B={B}, n={n}); kernel "
                f"{B / best['kernel'] * 1e3:.6e} grad-solves/s [{card}]")
            continue
        # K5 and K6 on both routes in turns, chained and the profiler's
        # kernel time a call
        mod = k6 if name == "k6" else k5
        routes, keys = ((K6_ROUTES, K6_KEYS) if name == "k6"
                        else (K5_ROUTES, K5_KEYS))
        new, first = routes
        steps = {route: fused_kernel(name, mesh, scale, block_lanes=512,
                                     plan=route) for route in routes}
        fns = {route: (lambda a, st=st: a - 1e-3 * st(a, F_, ud_)[1])
               for route, st in steps.items()}
        fns["plain"] = lambda a: a - 1e-3 * plain(a, F_, ud_)[1]
        best = timed_turns(fns, kap, 4, ("plain", first, new, new, first,
                                         "plain"))
        dev_ms = {route: device_ms(
            torch, lambda a, st=st: st(a, F_, ud_), kap, 20, keys[route],
            lambda route=route: mod.route_launches[route])
            for route, st in steps.items()}
        planned = (k6.k6_plan if name == "k6" else k5.k5_plan)(
            n, torch.float32)
        ms[what] = {"kernel": best[planned], "plain": best["plain"],
                    "chained": best, "device": dev_ms}
        store = 2 if ud_.dtype == torch.bfloat16 else 4
        b_ms, b_by = bound(B * fused_ops(name, n), B * fused_bytes(
            name, n, store, shared_f=F_.ndim == 1))
        log(f"phase 20 {what} (B={B}, n={n}, "
            f"{'bf16' if store == 2 else 'f32'} u_data, "
            f"{'shared' if F_.ndim == 1 else 'streamed'} F), chained in "
            f"turns: {new} {best[new]:.4f} ms, {first} (first design) "
            f"{best[first]:.4f} ms ({best[first] / best[new]:.2f}x), "
            f"plain {best['plain']:.4f} ms; kernel time a call (profiler): "
            f"{new} {dev_ms[new]:.4f} ms, {first} {dev_ms[first]:.4f} ms "
            f"({dev_ms[first] / dev_ms[new]:.2f}x); bound {b_ms:.4f} ms "
            f"({b_by}), {new} {dev_ms[new] / b_ms:.2f}x bound; the plan's "
            f"route {planned}, {B / best[planned] * 1e3:.6e} grad-solves/s "
            f"[{card}]")
        if name == "k6":
            warp = ms[f"k5b_{what.split('_')[1]}"]["device"]["warp"]
            log(f"phase 20 {what} beside K5b's warp route on the same "
                f"workload, kernel time a call: K6 reg {dev_ms['reg']:.4f} "
                f"ms, K5b warp {warp:.4f} ms ({warp / dev_ms['reg']:.2f}x) "
                f"[{card}]")
    # K5's routes by n and batch, streamed F and f32 planes: at 1-4 slots
    # a lane (n = 31 the workloads', 33 the first past one slot), the
    # evidence for a plan without a batch threshold
    for nn in K5_SWEEP_NS:
        meshes, lk, ke, F_n, ud_n = fused_operands(
            torch, dev, nn, K5_SWEEP_BS[-1], gen, (0.0, 0.0), False, False)
        F_n, ud_n = F_n.float(), ud_n.float()
        for name, a in (("k5a", lk.float()), ("k5b", ke.float())):
            row = []
            for Bs in K5_SWEEP_BS:
                t = {route: device_ms(
                    torch, lambda x, st=fused_kernel(name, meshes[0], 1.0,
                                                     plan=route):
                    st(x, F_n[:Bs], ud_n[:Bs]), a[:Bs], 20, K5_KEYS[route],
                    lambda route=route: k5.route_launches[route], False)
                    for route in K5_ROUTES}
                row.append(f"B={Bs} " + ", ".join(
                    f"{route} " + ("not measured" if t[route] is None
                                   else f"{t[route]:.4f} ms")
                    for route in K5_ROUTES))
            log(f"phase 20 {name} kernel time a call at n={nn} "
                f"(profiler): " + "; ".join(row) + f" [{card}]")
        del meshes, lk, ke, F_n, ud_n
    # K6's routes by n and batch, shared F and f32 planes (probe_thomas's
    # layout): the reg route where its bucket takes n, the block route
    # everywhere; past the reg route's n, B = 2^21 is left out (the block
    # route alone, which the workload's rows above time)
    for nn in K6_SWEEP_NS:
        reg = nn <= k6.K6_REG_MAX_NODES
        batches = K6_SWEEP_BS if reg else K6_SWEEP_BS[:-1]
        meshes, _, ke, F_n, ud_n = fused_operands(
            torch, dev, nn, batches[-1], gen, (0.3, -0.2), True, False)
        F_n, ud_n, ke = F_n.float(), ud_n.float(), ke.float()
        routes = [r for r in K6_ROUTES if r == "block" or reg]
        row = []
        for Bs in batches:
            t = {route: device_ms(
                torch, lambda x, st=fused_kernel("k6", meshes[0], 1.0,
                                                 plan=route):
                st(x, F_n, ud_n[:Bs]), ke[:Bs], 20, K6_KEYS[route],
                lambda route=route: k6.route_launches[route], False)
                for route in routes}
            row.append(f"B={Bs} " + ", ".join(
                f"{route} " + ("not measured" if t[route] is None
                               else f"{t[route]:.4f} ms")
                for route in routes))
        log(f"phase 20 k6 kernel time a call at n={nn} (profiler, shared "
            f"F): " + "; ".join(row) + f" [{card}]")
        del meshes, ke, F_n, ud_n
    torch.cuda.empty_cache()
    # K7 on both routes in turns at the phase 18/19 workloads: the
    # production step (v2, streamed f32 F and u_data) and the bench row
    k7_work = {"k7": (2, 0, torch.zeros(BATCH_PROD, device=dev), F, u_data,
                      production.LR, 4, False),
               "k7_bench": (3, 2, lk0, Fs, ud_q, 1e-3, 2, True)}
    for what, (v, r, kap, F_, ud_, lr, store, shared) in k7_work.items():
        fns = {route: (lambda a, kern=fused_kernel("k7", mesh, scale, v, r,
                                                   plan=route):
                       a - lr * kern(a, F_, ud_)[1])
               for route in ("tc", "fma")}
        plain = fused_plain("k7", mesh, scale, v, r)
        fns["plain"] = lambda a: a - lr * plain(a, F_, ud_)[1]
        best = timed_turns(fns, kap, 4,
                           ("plain", "fma", "tc", "tc", "fma", "plain"))
        B = kap.shape[0]
        # device time of a step, each route's launch and the plain
        # version's kernels: the production chain is host-bound on the tc
        # route (phase 20's wrapper time and profile)
        dev_ms = {route: device_ms(torch, fns[route], kap, 20, key)
                  for route, key in (("tc", "tc_kernel"),
                                     ("fma", "mxu_kernel"))}
        dev_ms["plain"] = device_ms(
            torch, lambda a: plain(a, F_, ud_), kap, 20)
        ms[what] = {"kernel": dev_ms["tc"], "plain": dev_ms["plain"]}
        ms[f"{what}_fma"] = dev_ms["fma"]
        bounds = {route: k7_bound(route, n, B, v, r, store, shared)
                  for route in ("tc", "fma")}
        for route in ("tc", "fma"):
            b_ms, b_by = bound(*bounds[route][:2], bounds[route][2])
            log(f"phase 20 {what} on the {route} route (v{v} r{r}, B={B}, "
                f"{'bf16' if store == 2 else 'f32'} u_data, "
                f"{'shared' if shared else 'streamed'} F): "
                f"{dev_ms[route]:.4f} ms a launch on the device (profiler), "
                f"{best[route]:.4f} ms a chained step, bound {b_ms:.4f} ms "
                f"({b_by}; operations at {bounds[route][3]}), "
                f"{dev_ms[route] / b_ms:.2f}x bound [{card}]")
        log(f"phase 20 {what} a step on the device (profiler): tc "
            f"{dev_ms['tc']:.4f} ms, fma {dev_ms['fma']:.4f} ms "
            f"({dev_ms['fma'] / dev_ms['tc']:.2f}x), plain "
            f"{dev_ms['plain']:.4f} ms; chained steps in turns: tc "
            f"{best['tc']:.4f} ms, fma {best['fma']:.4f} ms, plain "
            f"{best['plain']:.4f} ms [{card}]")
    X = torch.randn(BATCH_PROD, n, generator=gen, device=dev)
    Wt = k7.mxu_inverse(mesh).T
    Wt = (Wt / Wt.abs().sum(0).max()).contiguous()   # a contraction

    def two(c):
        return torch.matmul(torch.matmul(c, Wt), Wt)

    cublas = {}
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    for label in ("f32", "tf32"):
        torch.backends.cuda.matmul.allow_tf32 = label == "tf32"
        try:
            cublas[label] = (device_ms(torch, two, X, 20),
                             timeit_chained_min(two, X))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32_before
    log(f"phase 20 cuBLAS yardstick, two products X W^T, X ({BATCH_PROD}, "
        f"{n}), W ({n}, {n}) (not K7's function), on the device (profiler) "
        f"and chained: "
        + ", ".join(f"{k} {d:.4f} ms, {t:.4f} ms"
                    for k, (d, t) in cublas.items())
        + f"; K7's tc step on the device {ms['k7']['kernel']:.4f} ms "
        f"[{card}]")
    del X
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        production.sgd_loop(mesh, F, u_data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"phase 20 production loop host time, {production.STEPS} steps, "
        f"B={BATCH_PROD}: " + ", ".join(f"{t:.4f}" for t in times)
        + f" s; {BATCH_PROD * production.STEPS / min(times):.6e} "
        f"grad-solves/s [{card}]")
    lk_w = torch.zeros(BATCH_PROD, device=dev)
    for _ in range(3):
        k7.fused_kappa_mse_step_mxu(mesh, lk_w, F, u_data, scale=scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        k7.fused_kappa_mse_step_mxu(mesh, lk_w, F, u_data, scale=scale)
    t_host = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    log(f"phase 20 K7 wrapper host time a call (100 calls enqueued, no "
        f"synchronize): {t_host:.1f} µs [{card}]")
    profile_split(torch, lambda: production.sgd_loop(mesh, F, u_data),
                  "phase 20", card, what=f"production loop (B={BATCH_PROD})")
    log("phase 20 -Xptxas -v of the new kernels:")
    for line in ptxas_report(("fused_pcr_kernel", "fused_pcr_warp_kernel",
                              "thomas_kernel", "thomas_reg_kernel",
                              "fused_grad_mxu_cu")):
        log(line)
    spilled = [line for line in ptxas_report(("thomas_reg_kernel",))
               if " 0 bytes spill stores" not in line
               or " 0 bytes spill loads" not in line]
    if spilled:
        raise AssertionError(f"K6's reg route spills: {spilled}")
    log("phase 20 SASS of K6's float32 bodies:")
    for line in sass_report(("thomas_reg_kernel<16, float, 0>",
                             "thomas_reg_kernel<32, float, 0>",
                             "thomas_kernel<float, float, float, true>")):
        log(line)

    shapes = {
        "k5a": (BATCH_K5A, fused_ops("k5a", n), fused_bytes("k5a", n)),
        "k5b": (BATCH_BENCH, fused_ops("k5b", n),
                fused_bytes("k5b", n, shared_f=True)),
        "k6": (BATCH_BENCH, fused_ops("k6", n),
               fused_bytes("k6", n, shared_f=True)),
    }
    entries = []
    for name in ("k5a", "k5b", "k6"):
        B, ops, nbytes = shapes[name]
        key = name if name == "k5a" else f"{name}_f32"
        b_ms, b_by = bound(B * ops, B * nbytes)
        log(f"phase 20 {name} bound {b_ms:.4f} ms ({b_by}) at B={B}: "
            f"{B * ops / 1e9:.3f} GFLOP, {B * nbytes / 1e6:.1f} MB [{card}]")
        entries.append(kernel_entry(
            FUSED_NAMES[name], FUSED_SOURCES[name], FUSED_REPLACES[name],
            main_path[name], max_abs[name], ms[key]["kernel"],
            ms[key]["plain"], B * ops, B * nbytes))
    # K6's first design, the block route, chained on the same workload
    B, ops, nbytes = shapes["k6"]
    entries.append(kernel_entry(
        "fused_thomas_block", FUSED_SOURCES["k6"], FUSED_REPLACES["k6"],
        main_path["k6"], max_abs["k6_block"],
        ms["k6_f32"]["chained"]["block"], ms["k6_f32"]["plain"], B * ops,
        B * nbytes))
    # K7 at the production step's workload, on each route
    for route, name, key in (("tc", "fused_mxu", "k7"),
                             ("fma", "fused_mxu_fma", "k7_fma")):
        ops, nbytes, ops_s, _ = k7_bound(route, n, BATCH_PROD, 2, 0)
        entries.append(kernel_entry(
            name, FUSED_SOURCES["k7"], FUSED_REPLACES["k7"], main_path[key],
            max_abs[key], ms["k7"]["kernel"] if route == "tc"
            else ms["k7_fma"], ms["k7"]["plain"], ops, nbytes, None, ops_s))
    return entries


def general_mesh(torch, dev, cells, dtype, seed):
    """A factory rectangle or box on the unit square or cube with its
    interior nodes moved by U(±0.3h) along each axis (h = 1/cells) from
    ``seed``, built without a grid: the stencil routes would ignore moved
    nodes."""
    import numpy as np
    from difffe_tpu_torch.mesh import FEMesh

    f64 = torch.float64
    base = (FEMesh.rectangle(*cells, dtype=f64, device="cpu")
            if len(cells) == 2 else FEMesh.box(*cells, dtype=f64,
                                               device="cpu"))
    nodes = base.nodes.numpy().copy()
    inner = base.bc_mask.numpy() < 0.5
    rng = np.random.default_rng(seed)
    nodes[inner] += rng.uniform(-0.3, 0.3, nodes[inner].shape) / np.asarray(
        cells, np.float64)
    return FEMesh.from_arrays(nodes, base.elements.numpy(),
                              base.bc_mask.numpy(), base.bc_values.numpy(),
                              device=dev, dtype=dtype)


def k8_case(torch, mesh, B, gen, dtype):
    """K8 operands (nbr, W, diag, m) of a mesh's tables at B scenarios of
    per-element κ = 1 + U(0, 1)."""
    from difffe_tpu_torch.ops.unstructured import build_ell, ell_weights_bm

    ell = build_ell(mesh)
    ke = 1.0 + torch.rand(mesh.n_elements, B, generator=gen, dtype=dtype,
                          device=mesh.device)
    W, diag = ell_weights_bm(mesh, ell, ke)
    return ell, W, diag


def k8_bound(n, Dn, B, item=4):
    """(operations, bytes) of one K8 application."""
    ops = n * B * (K8_OPS_PER_SLOT * Dn + K8_OPS_PER_VALUE)
    nbytes = (n * Dn * B + 3 * n * B + n) * item + 4 * n * Dn
    return ops, nbytes


K8_KEYS = {"vec4": "ell_apply4_kernel", "scalar": "ell_apply_kernel"}


def k8_bodies(n, Dn, B, ptrs):
    """K8's bodies that take B scenarios on planes at ``ptrs``."""
    from difffe_tpu_torch.ops.kernels import ell_kernel as k8

    return (("vec4", "scalar") if k8.k8_body(n, Dn, B, ptrs) == "vec4"
            else ("scalar",))


def k8s_bound(nbr, W, m, iters):
    """(operations, bytes) of one K8s solve: the slots this data makes
    nonzero (both ends free, a nonzero weight) and every node, each
    iteration; W, diag, the right-hand side, nbr and m read once and x
    written once."""
    n, Dn, B = W.shape
    free = m == 0
    slots = int(((free[:, None] & free[nbr.long()])[..., None]
                 & (W != 0)).sum())
    ops = iters * (K8S_OPS_PER_SLOT * slots + K8S_OPS_PER_NODE * n * B)
    nbytes = (n * Dn * B + 3 * n * B) * W.element_size() + 4 * n * Dn \
        + m.element_size() * n
    return ops, nbytes


def ell_plans(n, Dn, limit):
    """Every K8s plan that fits: each cluster size."""
    from difffe_tpu_torch.ops.kernels import ell_kernel as k8
    from difffe_tpu_torch.ops.kernels.stencil_cg_kernel import CLUSTER_SIZES

    plans = []
    for c in CLUSTER_SIZES:
        try:
            plans.append(k8.ell_cluster_layout(n, Dn, c, limit))
        except ValueError:
            pass
    return plans


def ell_plan_text(plan):
    """A K8s plan as one log phrase."""
    if plan.route == "per_iteration":
        return "the per-iteration route (one K8 launch an application)"
    return (f"C = {plan.cluster}, {plan.block_bytes} bytes a block, "
            f"{plan.threads} threads")


def forced_ell_route(route):
    """``unstructured._ell_cg`` pinned to ``route``: "per_iteration" (K8 an
    operator application) or "plain" (K8s's plain version, with K8's for
    the right-hand side); returns a function that restores both."""
    from difffe_tpu_torch.ops import unstructured
    from difffe_tpu_torch.ops.kernels import ell_kernel as k8

    saved = unstructured._k8, unstructured._ell_cg
    if route == "plain":
        unstructured._k8 = k8.ell_apply_plain
        unstructured._ell_cg = k8.ell_cg_plain
    else:
        unstructured._ell_cg = lambda *a: k8.ell_cg(
            *a, plan=k8.per_iteration_plan(a[0].shape[0]))

    def restore():
        unstructured._k8, unstructured._ell_cg = saved
    return restore


def ell_route_timing(torch, label, mesh, ell, W, d, B, gen, card, length):
    """K8s at one shape, f32, ``ELL_ITERS`` iterations from a random masked
    right-hand side, each solve's x the next one's right-hand side: the
    plan's route against the per-iteration route in turns (per-iteration,
    plan, plan, per-iteration), every cluster size that fits, the plan's
    route at 0 iterations (the staging alone) and at
    twice the iterations (one CG iteration's time), and the plain version.
    Logs; returns (plan ms, per-iteration ms, plain ms, operations,
    bytes)."""
    from difffe_tpu_torch.ops.kernels import ell_kernel as k8
    from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as sk
    from difffe_tpu_torch.ops.kernels._build import load_library

    lib = load_library()
    n, Dn = ell.nbr.shape
    m, limit = mesh.bc_mask, sk.smem_optin(0)
    plan = k8.ell_cluster_plan(n, Dn, 4, limit)
    rhs = ((1.0 - m[:, None]) * torch.rand(n, B, generator=gen,
                                           device=m.device)).contiguous()

    def timed(p, iters=ELL_ITERS, chain=length):
        return timeit_chained_min(
            lambda v: k8.ell_cg(ell.nbr, W, d, m, v, 0.0, iters, plan=p),
            rhs, chain)

    best = {"plan": float("inf"), "per_iteration": float("inf")}
    for which in ("per_iteration", "plan", "plan", "per_iteration"):
        best[which] = min(best[which], timed(
            plan if which == "plan" else k8.per_iteration_plan(n)))
    plain = timeit_chained_min(
        lambda v: k8.ell_cg_plain(ell.nbr, W, d, m, v, 0.0, ELL_ITERS), rhs,
        2)
    ops, nbytes = k8s_bound(ell.nbr, W, m, ELL_ITERS)
    b_ms, b_by = bound(ops, nbytes)
    where = f"{n} nodes, Dn={Dn}, B={B}, {ELL_ITERS} iters"
    log(f"{label} at {where}: the plan's route ({ell_plan_text(plan)}) "
        f"{best['plan']:.4f} ms, the per-iteration route "
        f"{best['per_iteration']:.4f} ms, "
        f"{best['per_iteration'] / best['plan']:.2f}x; plain "
        f"{plain:.4f} ms; bound {b_ms:.4f} ms ({b_by}, {ops:.3e} "
        f"operations, {nbytes / 1e6:.1f} MB) [{card}]")
    sizes = []
    for p in ell_plans(n, Dn, limit):
        active = lib.difffe_ell_cg_clusters(n, Dn, p.cluster, p.threads)
        sizes.append(f"C={p.cluster} ({p.threads} threads, {p.block_bytes} "
                     f"B, {active} clusters at once) {timed(p):.4f} ms")
    log(f"{label} by cluster size at {where}: " + "; ".join(sizes)
        + f" [{card}]")
    staging, twice = timed(plan, 0), timed(plan, 2 * ELL_ITERS)
    active = lib.difffe_ell_cg_clusters(n, Dn, plan.cluster, plan.threads)
    waves = -(-B // active)
    per = (twice - best["plan"]) / ELL_ITERS * 1e3
    log(f"{label} at 0 iterations (staging and the initial dot) "
        f"{staging:.4f} ms, {100 * staging / best['plan']:.1f}% of the "
        f"solve; one CG iteration ({2 * ELL_ITERS} iters {twice:.4f} ms "
        f"less {ELL_ITERS}, over {ELL_ITERS}): {per:.3f} µs a launch; "
        f"{active} clusters at once, {waves} waves: {per / waves:.3f} µs "
        f"a cluster [{card}]")
    return best["plan"], best["per_iteration"], plain, ops, nbytes


def deterministic(torch, fn):
    """``fn()`` with torch's deterministic algorithms on (``index_add``
    without atomics), so that data built by a scatter repeat bit for bit
    from run to run."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(before)


def reset_all_launches():
    """Every kernel wrapper's launch count, set to 0; returns the dicts."""
    from difffe_tpu_torch.ops.kernels import (ell_kernel, fused_grad_cf_kernel,
                                              fused_grad_kernel,
                                              fused_grad_mxu_kernel,
                                              fused_grad_thomas_kernel,
                                              stencil3d_cg_kernel,
                                              stencil_cg_kernel,
                                              tridiag_kernel)

    counts = {}
    for mod in (fused_grad_cf_kernel, tridiag_kernel, stencil_cg_kernel,
                stencil3d_cg_kernel, fused_grad_kernel,
                fused_grad_thomas_kernel, fused_grad_mxu_kernel, ell_kernel):
        for key in mod.launches:
            mod.launches[key] = 0
        counts[mod.__name__.rsplit(".", 1)[1]] = mod.launches
    return counts


def check_only(counts, expected, what):
    """Raise unless the launches since the reset are exactly ``expected``
    ({module: {kernel: n}}; every other count 0)."""
    for mod, d in counts.items():
        for key, got in d.items():
            want = expected.get(mod, {}).get(key, 0)
            if got != want:
                raise AssertionError(f"{what}: {mod}.{key} launched {got} "
                                     f"times, expected {want}")


def run_general(torch, dev, card, seed):
    """Phases 21-23; returns the K8 and K8s entries of the kernels line."""
    from difffe_tpu_torch import (build_ell, fit_kappa,
                                  solve_poisson_cg_ell_batched)
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.assembly import assemble_load
    from difffe_tpu_torch.ops.kernels import ell_kernel as k8
    from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as sk
    from difffe_tpu_torch.solver import solve_poisson_batched

    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=dev).manual_seed(seed + 21)

    # -- phase 21: K8 against its plain version
    t0 = time.perf_counter()
    n, D, B = 256, 8, 8                 # P1's VMEM array and index table
    nbr = torch.randint(0, n, (n, D), generator=gen, device=dev,
                        dtype=torch.int32)
    cases = [("P1 n=256 D=8 B=8", nbr, torch.ones(n, D, B, dtype=f64,
                                                  device=dev),
              torch.zeros(n, B, dtype=f64, device=dev),
              torch.zeros(n, dtype=f64, device=dev))]
    mesh64 = general_mesh(torch, dev, (N_GEN, N_GEN), f64, seed)
    ell, W, diag = k8_case(torch, mesh64, BATCH_GEN, gen, f64)
    cases.append((f"{N_GEN}² triangulation B={BATCH_GEN}", ell.nbr, W, diag,
                   mesh64.bc_mask))
    mask = (torch.rand(mesh64.n_nodes, generator=gen, device=dev) < 0.3
            ).to(f64)
    cases.append((f"{N_GEN}² random mask B=7", ell.nbr,
                  W[..., :7].contiguous(), diag[:, :7].contiguous(), mask))
    box = general_mesh(torch, dev, (N_BOX_GEN,) * 3, f64, seed)
    ellb, Wb, db = k8_case(torch, box, BATCH_BOX_GEN, gen, f64)
    cases.append((f"{N_BOX_GEN}³ box B={BATCH_BOX_GEN}", ellb.nbr, Wb, db,
                  box.bc_mask))
    max_abs = 0.0
    for tag, nbr_, W_, d_, m_ in cases:
        v = torch.randn(nbr_.shape[0], W_.shape[2], generator=gen, dtype=f64,
                        device=dev)
        before = dict(k8.body_launches)
        y64 = k8.ell_apply(nbr_, W_, d_, v, m_)
        planned = next(b for b in k8.K8_BODIES
                       if k8.body_launches[b] != before[b])
        p64 = k8.ell_apply_plain(nbr_, W_, d_, v, m_)
        a32 = [t.to(f32) for t in (W_, d_, v, m_)]
        y32 = k8.ell_apply(nbr_, *a32)
        p32 = k8.ell_apply_plain(nbr_, *a32)
        # every body that takes the shape gives the plan's body's bits
        bodies = k8_bodies(*W_.shape, (W_.data_ptr(), d_.data_ptr(),
                                       v.data_ptr()))
        for body in bodies:
            for y, args in ((y64, (W_, d_, v, m_)), (y32, a32)):
                if not torch.equal(k8.ell_apply(nbr_, *args, body=body), y):
                    raise AssertionError(f"phase 21 {tag}: the {body} body "
                                         f"differs from the {planned} body")
        torch.cuda.synchronize()
        e64 = rel_err(y64, p64)
        if not e64 <= 1e-12:
            raise AssertionError(f"phase 21 {tag}: f64 rel err {e64:.3e}")
        ek, ep = check_rule("K8", y32, p32, p64, f"phase 21 {tag}")
        extra = ""
        if tag.startswith("P1"):
            want = v[nbr_.long()].sum(dim=1)
            e_p1 = rel_err(y64, want)
            if not e_p1 <= 1e-12:
                raise AssertionError(f"phase 21 {tag}: vs u[idx].sum(1) "
                                     f"{e_p1:.3e}")
            extra = f", f64 vs u[idx].sum(1) {e_p1:.3e}"
        if tag.startswith(f"{N_GEN}² triangulation"):
            max_abs = float((y32.double() - p64).abs().max())
        log(f"phase 21 K8 {tag} (Dn={nbr_.shape[1]}): f64 rel err "
            f"{e64:.3e}; f32 kernel {ek:.3e} vs plain {ep:.3e}{extra}; the "
            f"plan's body {planned}, bodies {', '.join(bodies)} equal bit "
            f"for bit")
    del cases, W, diag, Wb, db
    torch.cuda.empty_cache()
    log(f"phase 21 K8 vs plain: {time.perf_counter() - t0:.1f} s")

    # K8s against its plain version at every plan that fits
    t0 = time.perf_counter()
    limit = sk.smem_optin(0)
    max_abs_s = 0.0
    for cells, Bs in (((8, 8), 7), ((N_GEN, N_GEN), BATCH_GEN),
                      ((N_BOX_GEN,) * 3, BATCH_BOX_GEN)):
        m_ = general_mesh(torch, dev, cells, f64, seed)
        ell_, W_, d_ = k8_case(torch, m_, Bs, gen, f64)
        mk = m_.bc_mask
        rhs = (1.0 - mk[:, None]) * torch.rand(m_.n_nodes, Bs, generator=gen,
                                               dtype=f64, device=dev)
        rhs[:, Bs // 2] = 0.0
        n_, Dn = ell_.nbr.shape
        p64 = k8.ell_cg_plain(ell_.nbr, W_, d_, mk, rhs, 0.0, ELL_ITERS)
        a32 = [t.to(f32).contiguous() for t in (W_, d_, mk, rhs)]
        p32 = k8.ell_cg_plain(ell_.nbr, *a32, 0.0, ELL_ITERS)
        plan = k8.ell_cluster_plan(n_, Dn, 4, limit)
        tag = f"{'x'.join(map(str, cells))} B={Bs}"
        errs = []
        for p_ in ell_plans(n_, Dn, limit):
            what = f"phase 21 K8s {tag} {ell_plan_text(p_)}"
            x = k8.ell_cg(ell_.nbr, *a32, 0.0, ELL_ITERS, plan=p_)
            if not torch.equal(x, k8.ell_cg(ell_.nbr, *a32, 0.0, ELL_ITERS,
                                            plan=p_)):
                raise AssertionError(f"{what}: two launches differ")
            if x[:, Bs // 2].any():
                raise AssertionError(f"{what}: the zero right-hand side "
                                     f"gives a nonzero solution")
            ek, ep = check_rule("K8s", x, p32, p64, what)
            errs.append(f"C={p_.cluster} {ek:.2e}")
            if cells[0] == N_GEN and p_ == plan:
                max_abs_s = float((x.double() - p64).abs().max())
        log(f"phase 21 K8s {tag} ({n_} nodes, Dn={Dn}, {ELL_ITERS} iters; "
            f"plan {ell_plan_text(plan)}): rel err vs the f64 plain run, "
            f"kernel " + ", ".join(errs) + f"; f32 plain {ep:.2e}; two "
            f"launches equal bit for bit, the zero right-hand side 0")
        del ell_, W_, d_, p64, p32, a32
    torch.cuda.empty_cache()
    log(f"phase 21 K8s vs plain: {time.perf_counter() - t0:.1f} s")

    # -- phase 22: the main path
    mesh = general_mesh(torch, dev, (N_GEN, N_GEN), f32, seed)
    if mesh.grid is not None or (mesh.n_nodes, mesh.n_elements) != (
            (N_GEN + 1) ** 2, 2 * N_GEN ** 2):
        raise AssertionError(f"phase 22 mesh: {mesh}")
    Bm = BATCH_GEN
    k_true = 1.0 + torch.rand(Bm, mesh.n_elements, generator=gen,
                              device=dev)
    x = mesh.nodes
    f = (2 * math.pi ** 2 * torch.sin(math.pi * x[:, 0])
         * torch.sin(math.pi * x[:, 1])).expand(Bm, mesh.n_nodes)
    t0 = time.perf_counter()
    ell = build_ell(mesh)
    log(f"phase 22 build_ell {mesh}: {time.perf_counter() - t0:.2f} s, "
        f"Dn={ell.nbr.shape[1]}, T={ell.edge_w.shape[2]}, "
        f"Di={ell.wdiag.shape[1]}")
    # the load's scatter-add in deterministic mode, so that a run's data
    # repeat bit for bit (with atomics their last bits move between runs);
    # no check below depends on it
    FB = deterministic(torch, lambda: assemble_load(mesh, f))
    with torch.no_grad():
        u_data = solve_poisson_cg_ell_batched(mesh, ell, k_true, FB, 0.0,
                                              UDATA_ITERS)
    torch.cuda.synchronize()
    counts = reset_all_launches()
    for key in k8.body_launches:
        k8.body_launches[key] = 0
    t0 = time.perf_counter()
    kappa, info = fit_kappa(mesh, f, u_data, steps=STEPS_GEN)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    main_launches = dict(counts["ell_kernel"])
    main_bodies = dict(k8.body_launches)
    if main_bodies != {"vec4": STEPS_GEN + 1, "scalar": 0}:
        raise AssertionError(f"phase 22: K8 bodies {main_bodies}, every "
                             f"launch on the vec4 body expected at B={Bm}")
    # a step: K8 for the right-hand side, K8s forward and adjoint; then the
    # eval solve: one of each
    want = {"ell_apply": STEPS_GEN + 1, "ell_cg": 2 * STEPS_GEN + 1}
    check_only(counts, {"ell_kernel": want}, "phase 22")
    hist = info["loss_history"]
    if info["path"] != "generic_ell_batchminor":
        raise AssertionError(f"phase 22 path {info['path']}")
    if not bool(torch.isfinite(hist).all() and torch.isfinite(kappa).all()):
        raise AssertionError("phase 22: non-finite loss or κ")
    loss0 = float(hist[0])
    if not info["eval_loss"] < 0.5 * loss0:
        raise AssertionError(f"phase 22: eval_loss {info['eval_loss']:.3e} "
                             f"not below half of {loss0:.3e}")
    log(f"phase 22 fit_kappa {STEPS_GEN} Adam steps, B={Bm}, iters "
        f"{info['iters']}: path {info['path']}, loss {loss0:.6e} → "
        f"{float(hist[-1]):.6e}, eval_loss {info['eval_loss']:.6e} "
        f"({loss0 / info['eval_loss']:.1f}× lower); launches "
        f"{main_launches} (K8 {STEPS_GEN} + 1, K8s 2 × {STEPS_GEN} + 1; "
        f"K8 by body {main_bodies}), "
        f"no other kernel; max |κ − κ_true| "
        f"{float((kappa - k_true).abs().max()):.3e}; {t_fit:.3f} s, "
        f"{t_fit / STEPS_GEN * 1e3:.3f} ms a step [{card}]")

    # the first step's loss and κ gradient (κ = 1, fit_kappa's start) on
    # K8s and on the per-iteration route, against the plain version (the
    # same solve with the plain versions swapped in)
    mesh_d = general_mesh(torch, dev, (N_GEN, N_GEN), f64, seed)
    ell_d = build_ell(mesh_d)

    def first_step(m_, ell_, dt, route):
        k = torch.ones_like(k_true, dtype=dt).requires_grad_()
        restore = forced_ell_route(route) if route else (lambda: None)
        try:
            u = solve_poisson_cg_ell_batched(m_, ell_, k, FB.to(dt), 0.0,
                                             ELL_ITERS)
            loss = ((u - u_data.to(dt)) ** 2).mean()
            loss.backward()
        finally:
            restore()
        return u.detach(), loss.detach().reshape(1), k.grad

    runs = {r: first_step(mesh, ell, f32, r)
            for r in (None, "per_iteration", "plain")}
    p64 = first_step(mesh_d, ell_d, f64, "plain")
    for i, name in enumerate(("u", "loss", "κ gradient")):
        ek, ep = check_rule("K8s", runs[None][i], runs["plain"][i], p64[i],
                            f"phase 22 {name}")
        ei, _ = check_rule("K8", runs["per_iteration"][i], runs["plain"][i],
                           p64[i], f"phase 22 {name}")
        log(f"phase 22 first step's {name} at κ = 1 ({ELL_ITERS} "
            f"iterations, seed {seed}): rel err vs the f64 plain run, K8s "
            f"{ek:.3e}, the per-iteration route {ei:.3e}, plain f32 "
            f"{ep:.3e}; K8s vs the per-iteration route "
            f"{rel_err(runs[None][i], runs['per_iteration'][i]):.3e}")
    del mesh_d, ell_d, runs, p64

    boxm = general_mesh(torch, dev, (N_BOX_GEN,) * 3, f32, seed)
    Bb = BATCH_BOX_GEN
    xb = boxm.nodes
    fb = (3 * math.pi ** 2 * torch.sin(math.pi * xb[:, 0])
          * torch.sin(math.pi * xb[:, 1])
          * torch.sin(math.pi * xb[:, 2])).expand(Bb, boxm.n_nodes)
    kb = 1.0 + torch.rand(Bb, boxm.n_elements, generator=gen, device=dev)
    with torch.no_grad():
        ub = solve_poisson_cg_ell_batched(boxm, build_ell(boxm), kb,
                                          assemble_load(boxm, fb), 0.0,
                                          UDATA_ITERS)
    _, info_b = fit_kappa(boxm, fb, ub, steps=10)
    hb = info_b["loss_history"]
    if info_b["path"] != "generic_ell_batchminor" or not (
            bool(torch.isfinite(hb).all()) and float(hb[-1]) < float(hb[0])):
        raise AssertionError(f"phase 22 box: {info_b['path']}, {hb}")
    log(f"phase 22 fit_kappa 10 steps on a perturbed {N_BOX_GEN}³ box "
        f"({boxm.n_nodes} nodes, {boxm.n_elements} tets), B={Bb}: loss "
        f"{float(hb[0]):.6e} → {float(hb[-1]):.6e}, eval_loss "
        f"{info_b['eval_loss']:.6e}")

    for n_el, dt in ((300, f32), (30, f64)):
        line = FEMesh.line(n_el, dtype=dt)
        Bl = 1024
        fl = (torch.sin(math.pi * line.nodes[:, 0]) + 1.0).expand(
            Bl, n_el + 1)
        kl = 1.0 + 2.0 * torch.rand(Bl, n_el, generator=gen, device=dev,
                                    dtype=dt)
        ul = solve_poisson_batched(line, kl, fl, method="tridiag")
        counts = reset_all_launches()
        _, info_l = fit_kappa(line, fl, ul, steps=128)
        torch.cuda.synchronize()
        check_only(counts, {}, f"phase 22 line({n_el}) {dt}")
        hl = info_l["loss_history"]
        if info_l["path"] != "cf_torch" or not (
                bool(torch.isfinite(hl).all())
                and bool(torch.all(hl[1:] < hl[:-1]))
                and info_l["eval_loss"] < float(hl[0])):
            raise AssertionError(f"phase 22 line({n_el}) {dt}: "
                                 f"{info_l['path']}, {hl}")
        log(f"phase 22 fit_kappa on FEMesh.line({n_el}) {dt}, B={Bl}, 128 "
            f"steps: path {info_l['path']} (no K1 launch), loss "
            f"{float(hl[0]):.6e} → {float(hl[-1]):.6e}, eval_loss "
            f"{info_l['eval_loss']:.6e}")

    # -- phase 23: timing
    ms, lib, k8s = {}, {}, {}
    for cells, Bt, length in (((N_GEN, N_GEN), BATCH_GEN, 8),
                              ((N_BOX_GEN,) * 3, BATCH_BOX_GEN, 8),
                              ((N_GEN_BIG, N_GEN_BIG), BATCH_GEN_BIG, 4)):
        t0 = time.perf_counter()
        m_ = mesh if cells == (N_GEN, N_GEN) else general_mesh(
            torch, dev, cells, f32, seed)
        ell_, W_, d_ = k8_case(torch, m_, Bt, gen, f32)
        key = f"{cells[0]}{'²' if len(cells) == 2 else '³'}"
        k8s[key] = ell_route_timing(torch, f"phase 23 K8s at {key}", m_,
                                    ell_, W_, d_, Bt, gen, card, length)
        if len(cells) == 3:     # K8 is timed on the triangulations
            del ell_, W_, d_
            continue
        # scaled to a contraction, so chained values stay bounded (the
        # work is the same)
        rho = float((W_.abs().sum(dim=1) + d_.abs()).max())
        W_, d_ = W_ / rho, d_ / rho
        nbr_, mk = ell_.nbr, m_.bc_mask
        v0 = torch.randn(m_.n_nodes, Bt, generator=gen, device=dev)
        Dn = nbr_.shape[1]
        bodies = k8_bodies(m_.n_nodes, Dn, Bt, (W_.data_ptr(),
                                                d_.data_ptr(), v0.data_ptr()))
        planned = bodies[0]
        fns = {body: (lambda c, body=body: k8.ell_apply(nbr_, W_, d_, c, mk,
                                                         body=body))
               for body in bodies}
        fns["plain"] = lambda c: k8.ell_apply_plain(nbr_, W_, d_, c, mk)
        best = timed_turns(fns, v0, 8, ("plain", "scalar", "vec4", "vec4",
                                        "scalar", "plain"))
        best["kernel"] = best[planned]
        valid = (torch.arange(Dn, device=dev) == 0) | (nbr_ != 0)
        rows = torch.arange(m_.n_nodes, device=dev)[:, None].expand(
            -1, Dn)[valid]
        A = torch.sparse_coo_tensor(
            torch.stack([rows, nbr_.long()[valid]]),
            torch.full((int(valid.sum()),), 1.0 / Dn, device=dev),
            (m_.n_nodes, m_.n_nodes)).coalesce().to_sparse_csr()
        t_lib = timeit_chained_min(lambda c: torch.sparse.mm(A, c), v0,
                                   length=8)
        ops, nbytes = k8_bound(m_.n_nodes, Dn, Bt)
        b_ms, b_by = bound(ops, nbytes)
        dev_ms = {body: device_ms(torch, fns[body], v0, 20, K8_KEYS[body],
                                  lambda body=body: k8.body_launches[body])
                  for body in bodies}
        # each body again after a read of twice the L2 before every call
        # (the read is not keyed, and leaves no dirty line to write back):
        # repeated calls on operands that fit the L2 read part of them
        # from it, so only this time is held against a bound of
        # device-memory bytes
        flush = torch.zeros(2 * L2_BYTES // 4, device=dev)

        def cold(body):
            def call(c):
                flush.sum()
                return fns[body](c)
            return device_ms(torch, call, v0, 20, K8_KEYS[body],
                             lambda: k8.body_launches[body])

        cold_ms = {body: cold(body) for body in bodies}
        del flush
        dev_ms["plain"] = device_ms(torch, fns["plain"], v0, 20)
        dev_ms["library"] = device_ms(torch, lambda c: torch.sparse.mm(A, c),
                                      v0, 20)
        ms[key] = {"kernel": dev_ms[planned], "plain": dev_ms["plain"]}
        lib[key] = dev_ms["library"]
        log(f"phase 23 K8 at {key} ({m_.n_nodes} nodes, Dn={Dn}), B={Bt}, "
            f"f32, in turns: vec4 body {best['vec4']:.4f} ms "
            f"({nbytes / best['vec4'] / 1e6:.1f} GB/s), scalar body (first "
            f"design) {best['scalar']:.4f} ms "
            f"({nbytes / best['scalar'] / 1e6:.1f} GB/s, "
            f"{best['scalar'] / best['vec4']:.2f}x), the plan's {planned}; "
            f"plain {best['plain']:.4f} ms, torch.sparse.mm (CSR 0/1 "
            f"adjacency, {int(valid.sum())} entries) {t_lib:.4f} ms; bound "
            f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB); kernel time a "
            f"call (profiler): vec4 {dev_ms['vec4']:.4f} ms "
            f"({nbytes / dev_ms['vec4'] / 1e6:.1f} GB/s, "
            f"{dev_ms['vec4'] / b_ms:.2f}x bound), scalar "
            f"{dev_ms['scalar']:.4f} ms "
            f"({nbytes / dev_ms['scalar'] / 1e6:.1f} GB/s, "
            f"{dev_ms['scalar'] / dev_ms['vec4']:.2f}x), plain "
            f"{dev_ms['plain']:.4f} ms, torch.sparse.mm "
            f"{dev_ms['library']:.4f} ms; after a read of twice the L2 "
            f"before each call (operands {nbytes / 1e6:.1f} MB, the L2 "
            f"{L2_BYTES / 1e6:.1f}): vec4 {cold_ms['vec4']:.4f} ms "
            f"({nbytes / cold_ms['vec4'] / 1e6:.1f} GB/s, "
            f"{cold_ms['vec4'] / b_ms:.2f}x bound), scalar "
            f"{cold_ms['scalar']:.4f} ms "
            f"({cold_ms['scalar'] / cold_ms['vec4']:.2f}x); set-up "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        del ell_, W_, d_, A, v0
        torch.cuda.empty_cache()
    log("phase 23 -Xptxas -v of K8's bodies:")
    for line in ptxas_report(("ell_apply",)):
        log(line)

    def fit10():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_kappa(mesh, f, u_data, steps=10, eval_final=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    per_step = {"k8s": float("inf"), "per_iteration": float("inf")}
    for route in ("per_iteration", "k8s", "k8s", "per_iteration"):
        restore = (forced_ell_route(route) if route == "per_iteration"
                   else (lambda: None))
        try:
            per_step[route] = min(per_step[route], fit10() / 10 * 1e3)
        finally:
            restore()
    log(f"phase 23 fit_kappa host time at {N_GEN}², B={Bm}: {STEPS_GEN} "
        f"steps on K8s with the eval solve (phase 22's call) {t_fit:.4f} "
        f"s, {t_fit / STEPS_GEN * 1e3:.3f} ms a step, "
        f"{Bm * STEPS_GEN / t_fit:.6e} grad-solves/s; 10 steps without it, "
        f"in turns: K8s {per_step['k8s']:.3f} ms a step, the per-iteration "
        f"route {per_step['per_iteration']:.3f} ms a step, "
        f"{per_step['per_iteration'] / per_step['k8s']:.2f}x [{card}]")
    profile_split(torch, lambda: fit_kappa(mesh, f, u_data, steps=10,
                                           eval_final=False),
                  "phase 23", card, what=f"fit_kappa (10 steps, B={Bm})")

    ops, nbytes = k8_bound(mesh.n_nodes, ell.nbr.shape[1], Bm)
    key = f"{N_GEN}²"
    ms_s, _, plain_s, ops_s, bytes_s = k8s[key]
    return [
        kernel_entry("ell_apply", K8_SOURCE,
                     f"{P1_PROBE}:29 (try_kernel → pallas_call :31)",
                     main_launches["ell_apply"], max_abs, ms[key]["kernel"],
                     ms[key]["plain"], ops, nbytes, lib[key]),
        kernel_entry("ell_cg", K8S_SOURCE,
                     f"{P1_PROBE}:29 (try_kernel → pallas_call :31) with "
                     f"the CG around it, {JAX_ELL_CG}:249",
                     main_launches["ell_cg"], max_abs_s, ms_s, plain_s,
                     ops_s, bytes_s),
    ]


ABL_NS = (13, 31)         # phase 24: nodes
ABL_BS = (1000, 2 ** 21)  # phase 24: batches
ABL_SOURCE = "difffe_tpu_torch/csrc/k7_ablation.cu"
P2_PROBE = "scripts/probe_mxu_kernel.py"
ABL_NAMES = {"A1": "k7_ablation_a1_staged_v1",
             "B": "k7_ablation_b_3xtf32", "C": "k7_ablation_c_bf16",
             "D": "k7_ablation_d_one_product",
             "E": "k7_ablation_e_no_shifts",
             "F": "k7_ablation_f_register_rows",
             "tcA": "k7_ablation_tca_tc_route_v1",
             "tcB": "k7_ablation_tcb_tf32",
             "tcC": "k7_ablation_tcc_bf16",
             "tcD": "k7_ablation_tcd_one_product",
             "tcE": "k7_ablation_tce_no_shifts",
             "tcF": "k7_ablation_tcf_two_tiles"}
TC_SOURCE = "difffe_tpu_torch/csrc/k7_ablation.cu + tc_step.cuh"
TC_GATED = ("tcA", "tcF")        # the tc set's parity gate


def ablation_ops(variant, n):
    """(product operations, row operations) of one scenario's step of a K7
    ablation, by fused_ops' convention for K7: 2n² a product pass (B, tcA,
    tcD, tcE and tcF make three TF32 passes a product, D and tcD one
    product) and 12n + 3 around them (E and tcE drop the shifts' 4n)."""
    from difffe_tpu_torch.probes import k7_ablation as ab

    math, products = ab.math_and_products(variant)
    passes = 3 if products == "tf32x3" else 1
    products_n = 1 if math == "D" else 2
    return (passes * products_n * 2 * n * n,
            12 * n + 3 - (4 * n if math == "E" else 0))


def ablation_bound(variant, n, B):
    """(operations, bytes, least seconds of the operations, rate label) of
    one step at n nodes and B scenarios with bf16 u_data and shared F.  B,
    C and the tc set run their products on the tensor cores beside the row
    work on the f32 pipes, so their operations take the larger of the two
    times; the others do both on the f32 pipes, one after the other."""
    from difffe_tpu_torch.probes import k7_ablation as ab

    prod, row = ablation_ops(variant, n)
    products = ab.math_and_products(variant)[1]
    tensor = variant in ("B", "C") or variant in ab.TC_SET
    rate, label = ((PEAK_BF16, "bf16 989 TFLOP/s") if products == "bf16"
                   else (PEAK_TF32, "TF32 495 TFLOP/s") if tensor
                   else (PEAK_FLOPS, "f32 67 TFLOP/s"))
    t_prod, t_row = prod / rate, row / PEAK_FLOPS
    ops_s = B * (max(t_prod, t_row) if tensor else t_prod + t_row)
    return (B * (prod + row), B * fused_bytes("k7", n, 2, shared_f=True),
            ops_s, label)


def run_ablation(torch, dev, card):
    """Phase 24; returns the entries of the kernels line for A1 and B-F
    (A's is K7's)."""
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
    from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
    from difffe_tpu_torch.probes import k7_ablation as ab
    from difffe_tpu_torch.utils.profiling import timeit_chained

    gen = torch.Generator(device=dev).manual_seed(24)

    # -- phase 24, each variant of both sets against its plain version
    t0 = time.perf_counter()
    max_abs = {v: 0.0 for v in ab.ALL_VARIANTS}
    for n in ABL_NS:
        for B in ABL_BS:
            for bc in ((0.0, 0.0), (0.3, -0.2)):
                for bf16 in (False, True):
                    meshes, lk, _, F, ud = fused_operands(
                        torch, dev, n, B, gen, bc, True, bf16)
                    m32, m64 = meshes
                    scale = 2.0 / (B * n)
                    ud32 = ud.float().bfloat16() if bf16 else ud.float()
                    a32 = (lk.float(), F.float(), ud32)
                    a64 = (lk, F.float().double(), ud32.double())
                    c32, W32 = k5.scalar_columns(m32), k7.mxu_inverse(m32)
                    c64, W64 = k5.scalar_columns(m64), k7.mxu_inverse(m64)
                    what = (f"phase 24 n={n} B={B} bc={bc} "
                            f"{'bf16' if bf16 else 'f32'} u_data")
                    errs, out = [], {}
                    for v in ab.ALL_VARIANTS:
                        k = ab.ablation_step(v, m32, *a32, scale)
                        p32 = ab.plain_step(v, *a32, c32, W32, scale)
                        p64 = ab.plain_step(v, *a64, c64, W64, scale)
                        for label, a, b, c in zip(("loss", "grad"), k, p32,
                                                  p64):
                            ek, ep = check_rule(v, a, b, c,
                                                f"{what} {v} {label}",
                                                ab.rule_slack(v, n))
                        errs.append(f"{v} {ek:.1e}/{ep:.1e}")
                        if n == N_PROD + 1:
                            max_abs[v] = max(max_abs[v], float(
                                (k[1].double() - p64[1]).abs().max()))
                        out[v, "f32"] = k
                        if v in ("A", "A1", "D", "E", "F"):
                            k64 = ab.ablation_step(v, m64, *a64, scale)
                            for label, a, c in zip(("loss", "grad"), k64,
                                                   p64):
                                e = rel_err(a, c)
                                if not e <= 1e-10:
                                    raise AssertionError(
                                        f"{what} {v} {label} f64: rel err "
                                        f"{e:.3e}")
                            out[v, "f64"] = k64
                    for prec in ("f32", "f64"):
                        for v in ("F", "A1"):
                            for a, b in zip(out[v, prec], out["A", prec]):
                                if not torch.equal(a, b):
                                    raise AssertionError(
                                        f"{what}: {v} differs from A "
                                        f"({prec})")
                    # tcA is K7's "tc" route at version 1; tcF gives its
                    # bits with two tiles a warp
                    k7_tc = k7.fused_kappa_mse_step_mxu(
                        m32, *a32, scale=scale,
                        operand_dtype=torch.bfloat16 if bf16 else None,
                        version=1, refine=0, plan="tc")
                    for v in ("tcA", "tcF"):
                        for a, b in zip(out[v, "f32"], k7_tc):
                            if not torch.equal(a, b):
                                raise AssertionError(
                                    f"{what}: {v} differs from K7's tc "
                                    f"route")
                    log(f"{what}: grad error against the f64 plain version, "
                        f"kernel/plain f32 " + ", ".join(errs)
                        + "; F and A1 equal A bit for bit (f32, f64); tcA "
                        "and tcF equal K7's tc route v1 bit for bit")
                    del meshes, lk, F, ud, ud32, a32, a64, out, k7_tc
            torch.cuda.empty_cache()
    log(f"phase 24 kernel vs plain: {time.perf_counter() - t0:.1f} s")

    # -- phase 24, the probe's path: staging, parity and timing
    counts = reset_all_launches()
    for v in ab.launches:
        ab.launches[v] = 0
    mesh = FEMesh.line(ab.N_ELEM, dtype=torch.float32, device=dev)
    n, B = mesh.n_nodes, ab.BATCH
    st = ab.stage(mesh, B, torch.Generator(device=dev).manual_seed(0))
    g_ref = ab.oracle_grad(mesh, st)
    for v in ab.ALL_VARIANTS:
        rel = ab.parity(v, mesh, st, g_ref)
        gated = v in ("A", "A1", "B", "F") + TC_GATED
        log(f"phase 24 variant {v}: parity rel {rel:.3e} against the PCR "
            f"oracle on the bf16-quantized slice of {g_ref.shape[0]}"
            + (f" (limit {GATE_TOL})" if gated else " (not gated)"))
        if gated and not rel <= GATE_TOL:
            raise AssertionError(f"phase 24 variant {v}: parity {rel:.3e}")
    ms = {v: ab.run_variant(v, mesh, st) for v in ab.ALL_VARIANTS}
    torch.cuda.synchronize()
    want = 1 + 4 * ab.STEPS
    log(f"K7 ablation main-path launches: {dict(ab.launches)}, "
        f"k7 (fma route, A) {k7.launches['k7_fma']}, k7 (tc route, tcA) "
        f"{k7.launches['k7']}")
    if ab.launches != {v: want for v in ab.launches}:
        raise AssertionError(f"phase 24 launches {ab.launches}, expected "
                             f"{want} each")
    check_only(counts, {"fused_grad_mxu_kernel": {"k7_fma": want,
                                                  "k7": want}},
               "phase 24")
    # the probe path's counts, read before the profiler's calls add to them
    probe_launches = {v: k7.launches["k7"] if v == "tcA" else ab.launches[v]
                      for v in ab.ALL_VARIANTS if v != "A"}
    # the tc set's kernel time a call (profiler; tcF has a kernel of its
    # own)
    def tc_step(v, mesh_, st_):
        return lambda lk: ab.ablation_step(v, mesh_, lk, st_.F, st_.u_data,
                                           st_.scale)

    def tc_key(v):
        return "tc_two_tiles_kernel" if v == "tcF" else "tc_kernel"

    def tc_launched(v):
        return lambda: k7.launches["k7"] if v == "tcA" else ab.launches[v]

    dev_ms = {v: device_ms(torch, tc_step(v, mesh, st), st.log_k, 20,
                           tc_key(v), tc_launched(v))
              for v in ab.TC_VARIANTS}
    # tcA and tcF at n = 31 and, where tcF keeps its doubled arrays in
    # registers without a spill, at n = 13 (rows padded to 16): their grids
    # (the resident blocks an SM the occupancy API gave each; tcF's tiles
    # are 32 scenarios a warp, tcA's 16) and at n = 13 the kernel time
    mesh13 = FEMesh.line(12, dtype=torch.float32, device=dev)
    st13 = ab.stage(mesh13, B, torch.Generator(device=dev).manual_seed(0))
    at13 = {}
    for v in ("tcA", "tcF"):
        for nn, mesh_, st_ in ((n, mesh, st), (13, mesh13, st13)):
            shape = launch_shape(torch, tc_step(v, mesh_, st_), st_.log_k,
                                 tc_key(v))
            log(f"phase 24 {v}'s launch at n = {nn}: " + (
                "not measured (no kernel record in the trace)"
                if shape is None
                else f"grid {shape[0]}, {shape[1]:.2f} blocks an SM "
                     f"({4 * shape[1]:.2f} warps), {shape[2]} registers a "
                     f"thread") + f" [{card}]")
        at13[v] = device_ms(torch, tc_step(v, mesh13, st13), st13.log_k, 20,
                            tc_key(v), tc_launched(v))
    log(f"phase 24 tcA and tcF at n = 13, B = {B}, kernel time a call: "
        f"tcA {at13['tcA']:.4f} ms, tcF {at13['tcF']:.4f} ms "
        f"({at13['tcF'] / at13['tcA']:.3f}x tcA's) [{card}]")
    del st13

    plain_ms = {v: ab.run_variant(v, mesh, st, plain=True)
                for v in ab.ALL_VARIANTS}
    X = torch.randn(B, n, generator=gen, device=dev)
    Wt = k7.mxu_inverse(mesh).T
    Wt = (Wt / Wt.abs().sum(0).max()).contiguous()   # a contraction
    cublas = {}
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    for label, x0, w in (("f32", X, Wt), ("tf32", X, Wt),
                         ("bf16", X.bfloat16(), Wt.bfloat16())):
        torch.backends.cuda.matmul.allow_tf32 = label == "tf32"
        try:
            cublas[label] = timeit_chained(
                lambda c: torch.matmul(c, w), x0, length=ab.STEPS,
                repeats=3).min_s * 1e3
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32_before
    log(f"phase 24 cuBLAS torch.matmul(X, W.T), X ({B}, {n}), W ({n}, {n}): "
        + ", ".join(f"{k} {t:.4f} ms" for k, t in cublas.items())
        + f" [{card}]")
    entries = []
    for v in ab.ALL_VARIANTS:
        ops, nbytes, ops_s, rate = ablation_bound(v, n, B)
        b_ms, b_by = bound(ops, nbytes, ops_s)
        base = "tcA" if v in ab.TC_SET else "A"
        kt = (f" ({dev_ms[v]:.4f} ms kernel time a call, "
              f"{dev_ms[v] / b_ms:.2f}x bound, {dev_ms[v] / dev_ms['tcA']:.3f}x"
              f" tcA's)" if v in dev_ms else "")
        log(f"phase 24 {v}: {ms[v]:.4f} ms a step{kt}, "
            f"{B / ms[v] / 1e3:.1f} M solves/s, bound {b_ms:.4f} ms "
            f"({b_by}; operations at {rate}, bytes {nbytes / 1e6:.1f} MB), "
            f"{ms[v] / b_ms:.2f}x bound; plain {plain_ms[v]:.4f} ms; "
            f"{ms[v] / ms[base]:.3f}x {base} [{card}]")
        if v != "A":
            entries.append(kernel_entry(
                ABL_NAMES[v], TC_SOURCE if v in ab.TC_SET else ABL_SOURCE,
                f"{P2_PROBE}:162 (grad_call → pallas_call :163), variant {v}",
                probe_launches[v], max_abs[v], ms[v], plain_ms[v], ops, nbytes,
                None, ops_s))
    log("phase 24 -Xptxas -v of the new kernels:")
    for line in ptxas_report(("k7_ablation_cu",)):
        log(line)
    log("phase 24 SASS of the tc set's bodies at n = 31 (NT = 4) and of "
        "tcA's and tcF's at n = 13 (NT = 2), bf16 u_data:")
    for line in sass_report(tuple(
            f"tc_kernel<1, (Products){p}, 4, __nv_bfloat16, 0, ("
            for p in range(3)) + (
            "tc_kernel<1, (Products)0, 2, __nv_bfloat16, 0, (TcAblation)0>",
            "tc_two_tiles_kernel<4, __nv_bfloat16>",
            "tc_two_tiles_kernel<2, __nv_bfloat16>")):
        log(line)
    return entries


def natural_planes(torch, dev, n, B, variant, seed):
    """f64 inputs of K3a's natural route at an n² grid, B scenarios: a
    per-scenario κ pair, forcing and the Dirichlet values, with the
    generalized mask and natural terms of ``variant``: "natural" (Dirichlet
    on the left edge only, a per-scenario Neumann flux on the right edge,
    an axis-adjacent Robin term α = 2 on the top edge) or "pins" (the
    factory boundary and three interior pinned nodes, no natural term).
    Returns (grid, (kl, ku, f, g, m, qn, C_r, rload))."""
    from difffe_tpu_torch.ops.stencil import StructuredGrid

    grid = StructuredGrid.unit(n, n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    opts = dict(dtype=torch.float64, device=dev)
    kl = 1.2 + 0.6 * torch.rand(B, n, n, generator=gen, **opts)
    ku = 1.2 + 0.6 * torch.rand(B, n, n, generator=gen, **opts)
    xs = torch.linspace(0.0, 1.0, n + 1, **opts)
    Y, X = torch.meshgrid(xs, xs, indexing="ij")
    bump = torch.sin(math.pi * X) * torch.sin(math.pi * Y)
    f = 10.0 * bump * (1.0 + 0.2 * torch.rand(B, 1, 1, generator=gen,
                                              **opts))
    g = 0.3 * X + 0.1 * Y
    m = torch.zeros(n + 1, n + 1, **opts)
    qn = C_r = rload = None
    h = 1.0 / n
    if variant == "natural":
        m[:, 0] = 1.0
        qn = torch.zeros(B, n + 1, n + 1, **opts)
        qn[:, :, -1] = h * (1.0 + torch.rand(B, n + 1, generator=gen,
                                             **opts))
        # the top edge's boundary mass α·h/6·[[2, 1], [1, 2]] per segment
        alpha = 2.0
        C_r = torch.zeros(7, n + 1, n + 1, **opts)
        C_r[0, -1, :] = 4.0 * alpha * h / 6.0
        C_r[0, -1, [0, -1]] = 2.0 * alpha * h / 6.0
        C_r[1, -1, :-1] = alpha * h / 6.0
        C_r[2, -1, 1:] = alpha * h / 6.0
        rload = torch.zeros(n + 1, n + 1, **opts)
        rload[-1, :] = 0.5 * h
    else:
        m[[0, -1], :] = 1.0
        m[:, [0, -1]] = 1.0
        for r, c in ((n // 2, n // 2), (n // 4, 3 * n // 4),
                     (3 * n // 4, n // 3)):
            m[r, c] = 1.0
    return grid, (kl, ku, f, g, m, qn, C_r, rload)


def run_structured(torch, dev, card):
    """Phases 25-27; returns the entry of K3a's natural route for the
    kernels line."""
    import dataclasses

    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops import stencil_natural as nat
    from difffe_tpu_torch.ops import tridiag as ttri
    from difffe_tpu_torch.ops.assembly import (assemble_load,
                                               assemble_tridiag_1d)
    from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as sk
    from difffe_tpu_torch.ops.multigrid import mg_diagnostics
    from difffe_tpu_torch.ops.multigrid3 import (
        kappa_mse_grad_step_3d_mg, mg3_diagnostics,
        solve_poisson_structured_3d_mg)
    from difffe_tpu_torch.ops.neumann import boundary_edges, edge_flux_load
    from difffe_tpu_torch.ops.pcg import batched_dot, pcg
    from difffe_tpu_torch.ops.precision import (
        solve_poisson_structured_bf16, tridiag_solve_refined)
    from difffe_tpu_torch.ops.robin import robin_edges
    from difffe_tpu_torch.ops.spike import tridiag_solve_spike
    from difffe_tpu_torch.ops.stencil import (StructuredGrid,
                                              boundary_mask_grid,
                                              kappa_lu_from_elements,
                                              load_grid,
                                              solve_poisson_structured,
                                              stencil_apply,
                                              stencil_coefficients)
    from difffe_tpu_torch.ops.stencil3d import (StructuredGrid3,
                                                kappa_mse_grad_step_3d)
    from difffe_tpu_torch.solver import (_natural_terms, solve_poisson,
                                         solve_poisson_batched)
    from difffe_tpu_torch.utils.profiling import timeit_chained

    f32, f64 = torch.float32, torch.float64
    limit = sk.smem_optin(0)
    max_abs = 0.0

    # -- phase 25: K3a on natural and custom-mask planes against its plain
    # version, by the rule of phase 7, on the route its plan names
    t0 = time.perf_counter()
    for n, B in NAT_CASES:
        plan = sk.cluster_plan((n + 1) ** 2, 5, 4, limit)
        route = "cg" if plan.route == "cluster" else "cg_workspace"
        log(f"phase 25 K3a plan at {n}²: {plan_text(plan)}")
        for variant in ("natural", "pins"):
            grid, arrays = natural_planes(torch, dev, n, B, variant,
                                          seed=25 * n + B)
            before = dict(sk.launches)
            sols = {}
            for name, dt, cg in (("kernel", f32, sk._cg),
                                 ("f32", f32, sk._cg_plain),
                                 ("f64", f64, sk._cg_plain)):
                kl, ku, f, g, m, qn, C_r, rl = (
                    None if a is None else a.to(dt).contiguous()
                    for a in arrays)
                _, D, b, Minv, x0, _ = nat._prep_nat_pallas(
                    grid, (kl, ku), f, g, m, qn, C_r, rl)
                # a forward solve from m·g and an adjoint-style one from 0
                rhs = ((1.0 - m) * f).contiguous()
                sols[name] = (cg(D, b, Minv, x0, NAT_ITERS),
                              cg(D, rhs, Minv, torch.zeros_like(rhs),
                                 NAT_ITERS))
                if name == "kernel" and not torch.equal(
                        cg(D, b, Minv, x0, NAT_ITERS), sols[name][0]):
                    raise AssertionError(f"phase 25 K3a {variant} n={n}: "
                                         f"two launches differ")
            torch.cuda.synchronize()
            added = {k: sk.launches[k] - before[k] for k in sk.launches}
            want = {k: 3 if k == route else 0 for k in sk.launches}
            if added != want:
                raise AssertionError(f"phase 25 K3a {variant} n={n}: "
                                     f"launches {added}, expected {want}")
            errs = []
            for i in range(2):
                ek, ep = check_rule("K3a", sols["kernel"][i], sols["f32"][i],
                                    sols["f64"][i],
                                    f"phase 25 {variant} n={n} solve {i}")
                errs.append(f"({ek:.2e}, {ep:.2e})")
                max_abs = max(max_abs, float(
                    (sols["kernel"][i] - sols["f64"][i]).abs().max()))
            log(f"phase 25 K3a {variant} n={n} B={B} {NAT_ITERS} iters, "
                f"(kernel, f32 plain) rel err vs f64, forward and "
                f"adjoint-style: {', '.join(errs)}; launches by route "
                f"{added}; two launches equal bit for bit")
            del sols, arrays
            torch.cuda.empty_cache()

    # the main path: the facade's batched natural route at full width
    mesh0 = FEMesh.rectangle(N_NAT, N_NAT, dtype=f32)
    x, y = mesh0.nodes.T
    left = (x.abs() < 1e-6).to(f32)
    mesh = dataclasses.replace(mesh0, bc_mask=left,
                               bc_values=torch.zeros_like(left))
    grid, ne, nn = mesh.grid, mesh.n_elements, mesh.n_nodes
    H, W = grid.node_shape
    right = boundary_edges(mesh, predicate=lambda q: abs(q[0] - 1.0) < 1e-6)
    top = boundary_edges(mesh, predicate=lambda q: abs(q[1] - 1.0) < 1e-6)
    gen = torch.Generator(device=dev).manual_seed(25)
    flux = 1.0 + torch.rand(BATCH_NAT, nn, generator=gen, device=dev)
    nm = edge_flux_load(mesh, right, flux)
    rb = robin_edges(mesh, top, 2.0, 0.5 * torch.ones(nn, device=dev))
    k_true = 1.2 + 0.6 * torch.rand(BATCH_NAT, ne, generator=gen,
                                    device=dev)
    f = (10.0 * torch.sin(math.pi * x) * torch.sin(math.pi * y)).expand(
        BATCH_NAT, nn).contiguous()
    plan = sk.cluster_plan(H * W, 5, 4, limit)
    route = "cg" if plan.route == "cluster" else "cg_workspace"

    def facade(ke, f_):
        return solve_poisson_batched(mesh, ke, f_, neumann=nm, robin=rb,
                                     cg_tol=0.0, cg_maxiter=NAT_ITERS)

    counts = reset_all_launches()
    t1 = time.perf_counter()
    ke = k_true.clone().requires_grad_()
    u = facade(ke, f)
    (u ** 2).sum().backward()
    torch.cuda.synchronize()
    main_path = dict(counts["stencil_cg_kernel"])
    check_only(counts, {"stencil_cg_kernel": {route: 2}},
               "phase 25 natural route")
    log(f"phase 25 main path: solve_poisson_batched on "
        f"FEMesh.rectangle({N_NAT}, {N_NAT}) with Dirichlet on x = 0 only, "
        f"a per-scenario Neumann flux on x = 1 and a Robin edge on y = 1, "
        f"B={BATCH_NAT}, cg_tol=0, cg_maxiter={NAT_ITERS}, then the κ "
        f"gradient of Σu²: {time.perf_counter() - t1:.2f} s; K3a launches "
        f"{main_path}, every one on its plan's route ({plan.route})")

    def nat_plain(dtype):
        klu = kappa_lu_from_elements(grid, k_true.to(dtype))
        fg = f.to(dtype).reshape(BATCH_NAT, H, W)
        g0 = mesh.bc_values.to(dtype).reshape(H, W)
        m, qn, C_r, rl = (None if t is None else t.to(dtype)
                          for t in _natural_terms(mesh, nm, rb, f32))
        C_tot, D, b, Minv, x0, _ = nat._prep_nat_pallas(grid, klu, fg, g0, m,
                                                        qn, C_r, rl)
        up = sk._cg_plain(D, b, Minv, x0, NAT_ITERS)
        lam = sk._cg_plain(D, 2.0 * up, Minv, torch.zeros_like(up),
                           NAT_ITERS)
        gl, gu = nat._natural_cotangents(
            grid, klu, fg, g0, m, qn, C_r, rl, up, lam,
            lambda v: stencil_apply(C_tot, v))[:2]
        return (up.reshape(BATCH_NAT, nn),
                torch.stack([gl, gu], dim=-1).reshape(BATCH_NAT, ne))

    p32, p64 = nat_plain(f32), nat_plain(f64)
    # max_abs_err holds K3a's solutions, as the factory route's entry does
    max_abs = max(max_abs, float((u.detach() - p64[0]).abs().max()))
    for i, (name, out) in enumerate((("u", u.detach()), ("κ gradient",
                                                         ke.grad))):
        ek, ep = check_rule("K3a natural route", out, p32[i], p64[i],
                            f"phase 25 main path {name}")
        log(f"phase 25 main path {name}: rel err vs f64 plain {ek:.3e}, "
            f"f32 plain {ep:.3e}")
    del p32, p64

    # the unbatched natural PCG route against the dense route, f64
    mesh64 = dataclasses.replace(
        FEMesh.rectangle(N_NAT, N_NAT, dtype=f64), bc_mask=left.double(),
        bc_values=torch.zeros(nn, dtype=f64, device=dev))
    nm1 = edge_flux_load(mesh64, right, flux[0].double())
    rb1 = robin_edges(mesh64, top, 2.0, 0.5 * torch.ones(nn, dtype=f64,
                                                         device=dev))
    u_st = solve_poisson(mesh64, k_true[0].double(), f[0].double(),
                         neumann=nm1, robin=rb1)
    u_de = solve_poisson(mesh64, k_true[0].double(), f[0].double(),
                         method="dense", neumann=nm1, robin=rb1)
    err = rel_err(u_st, u_de)
    log(f"phase 25 unbatched natural PCG route (tol 1e-12) against the "
        f"dense route, f64, one scenario: rel err {err:.3e}")
    if not err <= 1e-9:
        raise AssertionError(f"phase 25 PCG against dense: {err:.3e}")
    del mesh64, u_st, u_de

    # timing: the facade call chained, K3a alone against its plain version
    # on the main path's planes, and K3a's share of a call's device time
    with torch.no_grad():
        call_ms = timeit_chained(lambda fc: fc + 1e-6 * facade(k_true, fc),
                                 f, length=3, repeats=2).min_s * 1e3
    log(f"phase 25 the natural facade call (forward, B={BATCH_NAT}, "
        f"{NAT_ITERS} iters), chained: {call_ms:.4f} ms [{card}]")
    klu = kappa_lu_from_elements(grid, k_true)
    m, qn, C_r, rl = _natural_terms(mesh, nm, rb, f32)
    _, D, b, Minv, x0, _ = nat._prep_nat_pallas(
        grid, klu, f.reshape(BATCH_NAT, H, W), mesh.bc_values.reshape(H, W),
        m, qn, C_r, rl)
    ms = timed_pair(lambda v: sk._cg(D, b, Minv, v, NAT_ITERS),
                    lambda v: sk._cg_plain(D, b, Minv, v, NAT_ITERS), x0, 2)
    log(f"phase 25 K3a on the natural planes ({N_NAT}², B={BATCH_NAT}, "
        f"{NAT_ITERS} iters, {plan.route} route): kernel "
        f"{ms['kernel']:.4f} ms/launch, plain {ms['plain']:.4f} ms/launch "
        f"[{card}]")

    def grad_call():
        ke_ = k_true.clone().requires_grad_()
        (facade(ke_, f) ** 2).sum().backward()

    rows, busy = profile_split(torch, grad_call, "phase 25", card,
                               what="natural facade forward + κ gradient")
    k3a = sum(t for key, _, t in rows
              if "cluster_cg_kernel" in key or "stencil_cg_kernel" in key)
    log(f"phase 25 K3a's share of the call's device time: {k3a:.2f} of "
        f"{busy:.2f} ms, {100 * k3a / busy:.1f}% [{card}]")
    del D, b, Minv, x0, u, ke, nm, flux
    torch.cuda.empty_cache()
    log(f"phase 25: {time.perf_counter() - t0:.1f} s")

    # -- phase 26: 2D MG, bf16 refinement, SPIKE (plain PyTorch: no kernel
    # may launch until the end of phase 27)
    t0 = time.perf_counter()
    counts = reset_all_launches()
    gen = torch.Generator(device=dev).manual_seed(26)
    its = []
    for n in MG_NS:
        grid = StructuredGrid.unit(n, n)
        kl = 1.0 + torch.rand(n, n, generator=gen, dtype=f64, device=dev)
        ku = 1.0 + torch.rand(n, n, generator=gen, dtype=f64, device=dev)
        xs = torch.linspace(0.0, 1.0, n + 1, dtype=f64, device=dev)
        fg = 10.0 * torch.outer(torch.sin(math.pi * xs),
                                torch.sin(math.pi * xs))
        g0 = torch.zeros_like(fg)
        t1 = time.perf_counter()
        u_w, it_w, r_w = mg_diagnostics(grid, (kl, ku), fg, g0, tol=1e-10)
        t_w = time.perf_counter() - t1
        _, it_v, r_v = mg_diagnostics(grid, (kl, ku), fg, g0, tol=1e-10,
                                      gamma=1)
        # the Jacobi-PCG of solve_poisson_structured, to the same tolerance
        C = stencil_coefficients(grid, kl, ku)
        m = boundary_mask_grid(grid, f64, dev)
        p = 1.0 - m
        rhs = p * load_grid(grid, fg)
        diag = m + p * C[0]
        t1 = time.perf_counter()
        u_j, it_j, _ = pcg(lambda v: m * v + p * stencil_apply(C, p * v),
                           rhs, lambda r: r / diag, torch.zeros_like(rhs),
                           1e-10, 100 * n, with_diagnostics=True)
        t_j = time.perf_counter() - t1
        u_s = solve_poisson_structured(grid, (kl, ku), fg, g0, 1e-10,
                                       100 * n)
        err = rel_err(u_w, u_s)
        its.append(it_w)
        log(f"phase 26 2D MG at {n}² (f64, to 1e-10): W-cycle {it_w} "
            f"iterations ({t_w:.3f} s host), V-cycle {it_v} (residual "
            f"{float(r_v):.2e}; 100 is mg_diagnostics' cap); "
            f"solve_poisson_structured's Jacobi-PCG {it_j} ({t_j:.3f} s "
            f"host); rel err MG vs it {err:.3e} [{card}]")
        if not (err <= 1e-8 and rel_err(u_j, u_s) <= 1e-12):
            raise AssertionError(f"phase 26 MG at {n}²: {err:.3e}")
    if not its[-1] <= 2.5 * its[0]:
        raise AssertionError(f"phase 26 MG iterations {its} grow with n")

    # bf16 inner CG under f32 refinement against the f64 oracle
    n, B = N_NAT, BATCH_BF16
    grid, arrays = natural_planes(torch, dev, n, B, "pins", seed=26)
    kl, ku, fg, g0 = arrays[:4]
    u64 = solve_poisson_structured(grid, (kl, ku), fg, g0, 1e-12, None,
                                   batched_dot(2))
    args32 = [a.float() for a in (kl, ku, fg, g0)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    u16 = solve_poisson_structured_bf16(grid, tuple(args32[:2]), *args32[2:],
                                        BF16_INNER, BF16_PASSES)
    torch.cuda.synchronize()
    t_bf = time.perf_counter() - t1
    errs = ((u16.double() - u64).abs().amax(dim=(-2, -1))
            / u64.abs().amax(dim=(-2, -1)))
    med, worst = float(errs.median()), float(errs.max())
    log(f"phase 26 solve_poisson_structured_bf16 at {n}², B={B}, "
        f"{BF16_INNER} inner × (1 + {BF16_PASSES}) passes: rel err vs f64 "
        f"per scenario, median {med:.3e} (tolerance {BF16_TOL_MEDIAN:g}), "
        f"worst {worst:.3e} ({BF16_TOL_MAX:g}); {t_bf:.3f} s host [{card}]")
    if not (med <= BF16_TOL_MEDIAN and worst <= BF16_TOL_MAX):
        raise AssertionError(f"phase 26 bf16 refinement: {med:.3e}, "
                             f"{worst:.3e}")
    del u64, u16, arrays, args32

    # SPIKE against PCR
    d64, e64 = k2_bands(torch, "random", N_SPIKE, BATCH_SPIKE, gen, dev)
    F64 = torch.randn(BATCH_SPIKE, N_SPIKE, generator=gen, dtype=f64,
                      device=dev)
    u_p = ttri.tridiag_solve(d64, e64, F64)
    e_s64 = rel_err(tridiag_solve_spike(d64, e64, F64, SPIKE_CHUNK), u_p)
    d32, e32, F32 = d64.float(), e64.float(), F64.float()
    e_s32 = rel_err(tridiag_solve_spike(d32, e32, F32, SPIKE_CHUNK), u_p)
    e_p32 = rel_err(ttri.tridiag_solve(d32, e32, F32), u_p)
    log(f"phase 26 SPIKE (chunk {SPIKE_CHUNK}) against PCR at n={N_SPIKE}, "
        f"B={BATCH_SPIKE}: f64 rel err {e_s64:.3e}; f32 rel err vs f64 PCR "
        f"{e_s32:.3e} (f32 PCR {e_p32:.3e})")
    if not (e_s64 <= SPIKE_F64_TOL and e_s32 <= SPIKE_F32_TOL):
        raise AssertionError(f"phase 26 SPIKE: {e_s64:.3e}, {e_s32:.3e}")
    best = timed_turns(
        {"spike": lambda Fc: Fc + 1e-6 * tridiag_solve_spike(
            d32, e32, Fc, SPIKE_CHUNK),
         "pcr": lambda Fc: Fc + 1e-6 * ttri.tridiag_solve(d32, e32, Fc)},
        F32, 3, ("pcr", "spike", "spike", "pcr"))
    log(f"phase 26 SPIKE against PCR, f32, chained: SPIKE "
        f"{best['spike']:.4f} ms, PCR {best['pcr']:.4f} ms a solve "
        f"[{card}]")
    del d64, e64, F64, u_p, d32, e32, F32

    # the refined bf16 PCR solve against the f64 oracle
    for n, passes, tol in REFINED_CASES:
        mesh = FEMesh.line(n, dtype=f32)
        xn = mesh.nodes[:, 0]
        d, e = assemble_tridiag_1d(mesh, torch.tensor(1.37, device=dev))
        F = assemble_load(mesh, torch.sin(math.pi * xn) + 1.0)
        m, g1 = mesh.bc_mask, mesh.bc_values
        p = 1.0 - m
        dm, em = p * d + m, p[:-1] * p[1:] * e
        Fm = m * g1 + p * (F - ttri.tridiag_matvec(d, e, m * g1))
        u64 = ttri.tridiag_solve(dm.double(), em.double(), Fm.double())
        errs = [rel_err(tridiag_solve_refined(dm, em, Fm, k), u64)
                for k in range(passes + 1)]
        log(f"phase 26 tridiag_solve_refined n={n} (κ = 1.37, load "
            f"sin(πx) + 1), rel err vs f64 after 0..{passes} passes: "
            + ", ".join(f"{x:.3e}" for x in errs) + f" (tolerance {tol:g})")
        if not errs[-1] <= tol:
            raise AssertionError(f"phase 26 refined n={n}: {errs[-1]:.3e}")
    log(f"phase 26: {time.perf_counter() - t0:.1f} s")

    # -- phase 27: 3D multigrid
    t0 = time.perf_counter()
    n, B = N_MG3_STEP, BATCH_MG3
    grid = StructuredGrid3.unit(n, n, n)
    shape = grid.node_shape
    kappa = 1.0 + torch.rand(B, grid.n_elements, generator=gen, dtype=f64,
                             device=dev)
    f3 = torch.randn((B,) + shape, generator=gen, dtype=f64, device=dev)
    g3 = torch.zeros(shape, dtype=f64, device=dev)
    ud = torch.randn((B,) + shape, generator=gen, dtype=f64, device=dev)
    loss_m, gk_m = kappa_mse_grad_step_3d_mg(grid, kappa, f3, g3, ud,
                                             MG3_ITERS)
    loss_j, gk_j = kappa_mse_grad_step_3d(grid, kappa, f3, g3, ud,
                                          JACOBI3_ITERS)
    e_loss = abs(float(loss_m) - float(loss_j)) / abs(float(loss_j))
    e_grad = rel_err(gk_m, gk_j)
    log(f"phase 27 kappa_mse_grad_step_3d_mg at {n}³, B={B}, f64, "
        f"{MG3_ITERS} iters against the Jacobi step at {JACOBI3_ITERS}: "
        f"loss rel err {e_loss:.3e}, κ gradient rel err {e_grad:.3e}")
    if not (e_loss <= 1e-9 and e_grad <= 1e-6):
        raise AssertionError(f"phase 27 MG step: {e_loss:.3e}, "
                             f"{e_grad:.3e}")
    args32 = [a.float() for a in (kappa, f3, g3, ud)]
    for name, step, iters in (("MG", kappa_mse_grad_step_3d_mg, MG3_ITERS),
                              ("Jacobi", kappa_mse_grad_step_3d,
                               JACOBI3_ITERS)):
        _, gk32 = step(grid, *args32, iters)
        log(f"phase 27 the f32 {name} step ({iters} iters): κ gradient rel "
            f"err vs the f64 Jacobi step {rel_err(gk32, gk_j):.3e}")
    del gk_m, gk_j, kappa, f3, ud

    def sgd(step, iters):
        return lambda k: k - 1e-3 * step(grid, k, *args32[1:], iters)[1]

    best = timed_turns({"mg": sgd(kappa_mse_grad_step_3d_mg, MG3_ITERS),
                        "jacobi": sgd(kappa_mse_grad_step_3d,
                                      JACOBI3_ITERS)},
                       args32[0], 1, ("jacobi", "mg", "mg", "jacobi"))
    log(f"phase 27 the 3D grad step at {n}³, B={B}, f32, chained: MG "
        f"({MG3_ITERS} iters) {best['mg']:.2f} ms, Jacobi "
        f"({JACOBI3_ITERS} iters) {best['jacobi']:.2f} ms, "
        f"{best['jacobi'] / best['mg']:.2f}x [{card}]")
    del args32
    torch.cuda.empty_cache()

    n = N_MG3_SOLVE
    grid = StructuredGrid3.unit(n, n, n)
    kappa = 1.0 + torch.rand(grid.n_elements, generator=gen, dtype=f64,
                             device=dev)
    f3 = torch.ones(grid.node_shape, dtype=f64, device=dev)
    g3 = torch.zeros_like(f3)
    t1 = time.perf_counter()
    u_mg, it_mg, rnorm = mg3_diagnostics(grid, kappa, f3, g3, tol=1e-10)
    t_mg = time.perf_counter() - t1
    u_solve = solve_poisson_structured_3d_mg(grid, kappa, f3, g3, tol=1e-10)
    log(f"phase 27 solve_poisson_structured_3d_mg at {n}³ (f64, to 1e-10):"
        f" {it_mg} iterations, residual {float(rnorm):.3e}, "
        f"{t_mg:.3f} s host [{card}]")
    if not (it_mg < 100 and bool(torch.isfinite(u_solve).all())
            and rel_err(u_solve, u_mg) <= 1e-12):
        raise AssertionError(f"phase 27 3D MG solve: {it_mg} iterations")
    check_only(counts, {}, "phases 26-27 (no kernel on these solvers)")
    log(f"phase 27: {time.perf_counter() - t0:.1f} s")

    n_nodes = BATCH_NAT * H * W
    return [kernel_entry(
        "stencil_cg_natural", K3_SOURCE, f"{JAX_K3}:191", main_path[route],
        max_abs, ms["kernel"], ms["plain"],
        K3_OPS_PER_NODE_ITER * n_nodes * NAT_ITERS, 9 * n_nodes * 4)]


def mpc_problem(torch, dev, dtype):
    """Phase 28's workload: ``FEMesh.line(64)``, one κ a scenario spaced
    evenly in [0.8, 1.6], targets a_b·sin(πx) with a_b spaced evenly in
    [0.1, 0.4] over the horizon, the demo's three actuators and planner."""
    from difffe_tpu_torch.control import MPCConfig, gaussian_actuators
    from difffe_tpu_torch.mesh import FEMesh

    mesh = FEMesh.line(N_MPC, dtype=dtype, device=dev)
    x = mesh.nodes[:, 0]
    kappa = torch.linspace(0.8, 1.6, BATCH_MPC, dtype=dtype, device=dev)
    amp = torch.linspace(0.1, 0.4, BATCH_MPC, dtype=dtype, device=dev)
    targets = (amp[:, None] * torch.sin(math.pi * x))[:, None, :].expand(
        BATCH_MPC, MPC_H, mesh.n_nodes)
    act = gaussian_actuators(mesh, MPC_CENTERS, MPC_WIDTH)
    cfg = MPCConfig(horizon=MPC_H, dt=MPC_DT, lr=MPC_LR,
                    plan_iters=MPC_ITERS, control_penalty=MPC_PENALTY)
    return mesh, kappa, targets, act, cfg


def stencil_cg_iters(torch, mesh, kappa_e, f):
    """Iterations of the tol-gated batched stencil CG that
    ``solve_poisson_batched`` runs for per-triangle κ (B, ne) and loads
    (B, n) on a rectangle (``solver._solve_stencil``'s forward solve, its
    default tolerance and cap), and the largest relative residual."""
    from difffe_tpu_torch.ops.pcg import batched_dot, pcg
    from difffe_tpu_torch.ops.stencil import (_operator, boundary_mask_grid,
                                              kappa_lu_from_elements,
                                              load_grid, stencil_apply,
                                              stencil_coefficients)
    from difffe_tpu_torch.solver import _cg_policy

    grid = mesh.grid
    shape = grid.node_shape
    kl, ku = kappa_lu_from_elements(grid, kappa_e)
    C = stencil_coefficients(grid, kl, ku)
    m = boundary_mask_grid(grid, f.dtype, f.device)
    p = 1.0 - m
    mg = m * mesh.bc_values.reshape(shape)
    b = p * (load_grid(grid, f.reshape(f.shape[:-1] + shape))
             - stencil_apply(C, mg))
    diag = m + p * C[..., 0, :, :]
    minv = 1.0 / torch.where(diag.abs() > 1e-30, diag, torch.ones_like(diag))
    tol, maxiter = _cg_policy(mesh, None, None)
    dot = batched_dot(2)
    _, iters, r = pcg(lambda v: _operator(C, m, v), b, lambda v: minv * v,
                      torch.zeros_like(b), tol, maxiter, dot=dot,
                      with_diagnostics=True)
    rel = (dot(r, r) / dot(b, b).clamp_min(1e-30)).sqrt()
    return iters, maxiter, tol, float(rel.max())


def run_control(torch, dev, card):
    """Phases 28-29; returns the K2 entry at the planner's shape."""
    from difffe_tpu_torch.control import (TopOptConfig, make_planner_batched,
                                          optimize_batched, receding_horizon,
                                          rollout, tracking_cost)
    from difffe_tpu_torch.control.heat import resolve_method
    from difffe_tpu_torch.control.topopt import (cone_filter_kernel,
                                                 density_filter,
                                                 oc_bisection_steps,
                                                 quads_to_tris, simp_kappa)
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops import tridiag as ttri
    from difffe_tpu_torch.ops.assembly import (assemble_lumped_mass,
                                               assemble_tridiag_1d)
    from difffe_tpu_torch.ops.kernels import tridiag_kernel as tk

    f32, f64 = torch.float32, torch.float64
    B = BATCH_MPC
    t0 = time.perf_counter()

    # -- phase 28: the rollout and the planner's q-gradient on K2 against
    # the same rollout on the plain PCR sweeps, by the rule of phase 7
    gen = torch.Generator(device=dev).manual_seed(28)
    q_rand = 0.5 * torch.randn(B, MPC_H, len(MPC_CENTERS), generator=gen,
                               dtype=f64, device=dev)

    def rollout_and_grad(dtype, method):
        mesh, kappa, targets, act, cfg = mpc_problem(torch, dev, dtype)
        q = q_rand.to(dtype).detach().clone().requires_grad_()
        k = kappa[:, None].expand(B, N_MPC)
        traj = rollout(mesh, k, torch.zeros(B, mesh.n_nodes, dtype=dtype,
                                            device=dev),
                       (q @ act).transpose(0, 1), MPC_DT, method=method)
        tracking_cost(mesh, traj.transpose(0, 1), targets, q,
                      cfg).sum().backward()
        return traj.detach(), q.grad

    mesh32 = mpc_problem(torch, dev, f32)[0]
    if resolve_method(mesh32) != "tridiag_pallas":
        raise AssertionError("the rollout's auto route on the card is not "
                             "K2's")
    kern, plain32, plain64 = (rollout_and_grad(f32, "auto"),
                              rollout_and_grad(f32, "tridiag"),
                              rollout_and_grad(f64, "tridiag"))
    for i, what in enumerate(("trajectory", "q-gradient of the cost")):
        ek, ep = check_rule("K2 rollout", kern[i], plain32[i], plain64[i],
                            f"phase 28 {what}")
        log(f"phase 28 the rollout's {what} on K2 (n={N_MPC + 1}, B={B}, "
            f"H={MPC_H}, f32): rel err vs f64 plain {ek:.3e} (f32 plain "
            f"{ep:.3e}) ({time.perf_counter() - t0:.1f} s in)")
    del kern, plain32, plain64
    torch.cuda.empty_cache()

    # the main path: one batched plan at config 3's width
    mesh, kappa, targets, act, cfg = mpc_problem(torch, dev, f32)
    plan = make_planner_batched(mesh, kappa, act, cfg)
    u0 = torch.zeros(B, mesh.n_nodes, device=dev)
    q0 = torch.zeros(B, MPC_H, len(MPC_CENTERS), device=dev)
    counts = reset_all_launches()
    t1 = time.perf_counter()
    q_opt, losses = plan(u0, targets, q0)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t1
    main_path = dict(tk.launches)
    want = 2 * MPC_H * MPC_ITERS
    log(f"phase 28 make_planner_batched: n={N_MPC + 1} B={B} H={MPC_H} "
        f"{MPC_ITERS} Adam steps, first plan {t_plan:.3f} s host; K2 "
        f"launches {main_path}")
    check_only(counts, {"tridiag_kernel": {"pcr": want}},
               "phase 28 plan (every step one K2 launch, warp route)")
    ratio = losses[:, -1] / losses[:, 0]
    log(f"phase 28 plan: cost ratio last/first over the {B} scenarios: min "
        f"{float(ratio.min()):.4f}, median {float(ratio.median()):.4f}, "
        f"max {float(ratio.max()):.4f}; first cost "
        f"{float(losses[:, 0].mean()):.6e} mean")
    if not (bool(torch.isfinite(losses).all())
            and bool(torch.isfinite(q_opt).all())
            and losses.shape == (B, MPC_ITERS)):
        raise AssertionError("phase 28 plan: losses or q not finite")
    if not float(ratio.max()) < MPC_COST_RATIO:
        raise AssertionError(f"phase 28 plan: a scenario's last cost is "
                             f"{float(ratio.max()):.4f} of its first")

    # the plan's host time over chained calls (each warm-started from the
    # last's controls), its profile, and K2's time a call at its shape
    times, q = [], q_opt
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        q, _ = plan(u0, targets, q)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    log(f"phase 28 plan host time, chained: "
        + ", ".join(f"{t:.4f}" for t in times)
        + f" s; {B * MPC_ITERS / min(times):.6e} scenario-plan-steps/s "
          f"({want} K2 launches a plan) [{card}]")
    rows, busy = profile_split(torch, lambda: plan(u0, targets, q0),
                               "phase 28", card,
                               what=f"make_planner_batched (B={B})",
                               cpu=False)
    k2_busy = sum(t for key, _, t in rows if "pcr_warp_kernel" in key)
    log(f"phase 28 K2's share of the plan's device time: {k2_busy:.2f} of "
        f"{busy:.2f} ms ({100 * k2_busy / busy:.1f}%) [{card}] "
        f"({time.perf_counter() - t0:.1f} s in)")

    n = N_MPC + 1
    M = assemble_lumped_mass(mesh)
    dK, eK = assemble_tridiag_1d(mesh, kappa[:, None].expand(B, N_MPC))
    dB, eB, _, _ = ttri.dirichlet_elimination(mesh, M + MPC_DT * dK,
                                              MPC_DT * eK)
    dB, eB = dB.contiguous(), eB.contiguous()
    F0 = torch.randn(B, n, generator=gen, device=dev)
    with torch.no_grad():
        u_k = tk.tridiag_solve_kernel(dB, eB, F0)
        u_64 = ttri.tridiag_solve(dB.double(), eB.double(), F0.double())
    max_abs = float((u_k.double() - u_64).abs().max())
    k2_ms = device_ms(torch, lambda c: tk.tridiag_solve_kernel(dB, eB, c),
                      F0, 20, "pcr_warp_kernel",
                      launched=lambda: tk.launches["pcr"])
    plain_ms = device_ms(torch, lambda c: ttri.tridiag_solve(dB, eB, c),
                         F0, 20)
    T = (torch.diag_embed(dB) + torch.diag_embed(eB, 1)
         + torch.diag_embed(eB, -1))
    lib_ms = device_ms(
        torch, lambda c: torch.linalg.solve(T, c[..., None])[..., 0], F0, 2)
    ops = B * n * (K2_OPS_PER_ROW_SWEEP * math.ceil(math.log2(n)) + 1)
    nbytes = (4 * n - 1) * B * 4
    b_ms, b_by = bound(ops, nbytes)
    log(f"phase 28 K2 at the planner's shape (n={n}, B={B}, f32, warp "
        f"route), kernel time a call (profiler): {k2_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB), plain "
        f"{plain_ms:.4f} ms, torch.linalg.solve on the densified systems "
        f"{lib_ms:.4f} ms; max abs err vs f64 plain {max_abs:.3e} [{card}] "
        f"({time.perf_counter() - t0:.1f} s in)")
    del T, dB, eB, F0, u_k, u_64, q_opt, losses, q
    torch.cuda.empty_cache()

    # receding_horizon as examples/heat_mpc_demo.py runs it: one scenario,
    # so K2's block route
    x = mesh.nodes[:, 0]
    target_field = 0.3 * torch.sin(math.pi * x)
    target = target_field.expand(MPC_H, mesh.n_nodes)
    counts = reset_all_launches()
    t1 = time.perf_counter()
    states, controls = receding_horizon(mesh, 1.0, torch.zeros_like(x), act,
                                        target, cfg, MPC_RH_STEPS)
    torch.cuda.synchronize()
    t_rh = time.perf_counter() - t1
    free = torch.as_tensor(mesh.free_nodes(), device=dev)
    errs = [float((states[i][free] - target_field[free]).abs().max())
            for i in (0, MPC_RH_STEPS)]
    log(f"phase 28 receding_horizon (line({N_MPC}), B=1, {MPC_RH_STEPS} MPC "
        f"steps, H={MPC_H}, {MPC_ITERS} plan iterations): {t_rh:.3f} s "
        f"host, {t_rh / MPC_RH_STEPS:.4f} s a step; max tracking error "
        f"{errs[0]:.4f} -> {errs[1]:.4f}; final controls "
        f"{[round(float(c), 4) for c in controls[-1]]} [{card}]")
    check_only(counts, {"tridiag_kernel": {
        "pcr_block": MPC_RH_STEPS * (want + 1)}},
        "phase 28 receding_horizon (K2's block route at B = 1)")
    if not errs[1] < 0.5 * errs[0]:
        raise AssertionError(f"phase 28 receding_horizon: tracking error "
                             f"{errs[0]:.4f} -> {errs[1]:.4f}")
    log(f"phase 28: {time.perf_counter() - t0:.1f} s")

    # -- phase 29: topology optimization, config 5's topopt_2d, batched
    t0 = time.perf_counter()
    mesh = FEMesh.rectangle(N_TOPO, N_TOPO, dtype=f32, device=dev)
    cfg = TopOptConfig(nx=N_TOPO, ny=N_TOPO, n_iters=TOPO_ITERS)
    steps = oc_bisection_steps(f32)
    if steps != 25:
        raise AssertionError(f"the OC bisection takes {steps} steps")
    kernel = cone_filter_kernel(cfg.filter_radius, f32, dev)
    x = mesh.nodes[:, 0]
    gen_cpu = torch.Generator().manual_seed(29)
    for Bt in TOPO_BS:
        a = 0.5 * torch.rand(Bt, generator=gen_cpu).to(dev)
        f = 1.0 + a[:, None] * torch.sin(math.pi * x)
        counts = reset_all_launches()
        t1 = time.perf_counter()
        rho, hist = optimize_batched(mesh, f, cfg)
        torch.cuda.synchronize()
        t_opt = time.perf_counter() - t1
        check_only(counts, {}, "phase 29 (the tol-gated stencil CG is plain "
                               "PyTorch)")
        ratio = hist[:, -1] / hist[:, 0]
        vol = rho.mean((-2, -1))
        its = [stencil_cg_iters(torch, mesh, simp_kappa(quads_to_tris(
            density_filter(r, kernel)), cfg), f)
            for r in (torch.full_like(rho, cfg.vol_frac), rho)]
        log(f"phase 29 optimize_batched {N_TOPO}x{N_TOPO} B={Bt} "
            f"{TOPO_ITERS} OC iterations ({steps} bisection steps each): "
            f"{t_opt:.3f} s host, {1e3 * t_opt / TOPO_ITERS:.2f} ms an OC "
            f"iteration; compliance ratio last/first min "
            f"{float(ratio.min()):.4f} max {float(ratio.max()):.4f}; volume "
            f"{float(vol.min()):.4f}-{float(vol.max()):.4f}; rho in "
            f"[{float(rho.min()):.4f}, {float(rho.max()):.4f}]; state solve "
            + "; ".join(f"at the {w} rho {i} of {mx} iterations (tol "
                        f"{tol:g}, worst residual {r:.2e})"
                        for w, (i, mx, tol, r) in zip(("first", "last"),
                                                      its))
            + f" [{card}]")
        if not (bool(torch.isfinite(hist).all())
                and float(ratio.max()) < TOPO_RATIO
                and float((vol - cfg.vol_frac).abs().max()) < 0.02
                and float(rho.min()) >= 0.0 and float(rho.max()) <= 1.0):
            raise AssertionError(f"phase 29 B={Bt}: compliance ratio "
                                 f"{float(ratio.max()):.4f}, volume "
                                 f"{float(vol.min()):.4f}-"
                                 f"{float(vol.max()):.4f}")
        del rho, hist, f
    log(f"phase 29: {time.perf_counter() - t0:.1f} s")

    replaces = f"{JAX_K2}:80 (_pcr_pallas_padded), :161 (_pcr_pallas_T)"
    return [kernel_entry("tridiag_pcr_mpc", K2_SOURCE, replaces,
                         main_path["pcr"], max_abs, k2_ms, plain_ms, ops,
                         nbytes, lib_ms)]


def run_surrogates(torch, dev, card):
    """Phase 30: the DeepONet and collocation surrogates on the card."""
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.models.collocation import train_collocation
    from difffe_tpu_torch.models.operator import train_operator
    from difffe_tpu_torch.solver import solve_poisson_batched
    from difffe_tpu_torch.utils.profiling import timeit_chained

    f32 = torch.float32
    t0 = time.perf_counter()

    def family(mesh, kappas, method="auto"):
        """tests/test_operator.py's scenarios: features log κ, targets the
        FEM solutions of −κu″ = sin(πx) + 1."""
        x = mesh.nodes[:, 0]
        f = (torch.sin(math.pi * x) + 1.0).expand(kappas.shape[0],
                                                  mesh.n_nodes)
        with torch.no_grad():
            u = solve_poisson_batched(mesh, kappas, f, method=method,
                                      kappa_batched=True)
        return kappas.log()[:, None], u

    mesh = FEMesh.line(24, dtype=f32, device=dev)
    feats, u = family(mesh, torch.linspace(0.5, 2.5, 40, device=dev))
    counts = reset_all_launches()
    t1 = time.perf_counter()
    _, u_fn, losses = train_operator(mesh, feats, u, init=torch.Generator(
        ).manual_seed(0), **OP_GATE)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t1
    check_only(counts, {}, "phase 30 train_operator (no kernel)")
    feats_t, u_true = family(mesh, torch.tensor([0.77, 1.31, 2.05],
                                                device=dev))
    rel = float((u_fn(feats_t) - u_true).abs().max() / u_true.abs().max())
    log(f"phase 30 train_operator (line(24), 40 scenarios, width 48, depth "
        f"2, n_basis 24, 4000 epochs, f32): final loss "
        f"{float(losses[-1]):.3e}, held-out relative error {rel:.4f}; "
        f"{t_op:.3f} s host [{card}]")
    if not (float(losses[-1]) < 1e-5 and rel < 0.02):
        raise AssertionError(f"phase 30 train_operator: loss "
                             f"{float(losses[-1]):.3e}, error {rel:.4f}")

    # the JAX defaults on B = 4096 targets from config 2's line, solved on
    # K2 (one launch, the warp route)
    mesh = FEMesh.line(N_OP_BIG, dtype=f32, device=dev)
    counts = reset_all_launches()
    feats, u = family(mesh, torch.linspace(0.5, 2.5, BATCH_OP_BIG,
                                           device=dev), "tridiag_pallas")
    check_only(counts, {"tridiag_kernel": {"pcr": 1}},
               "phase 30 the operator's FEM targets")
    t1 = time.perf_counter()
    _, u_fn, losses = train_operator(mesh, feats, u)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t1
    infer = timeit_chained(lambda c: u_fn(c)[:, 1:2], feats, length=20)
    log(f"phase 30 train_operator at the defaults (width 64, depth 3, "
        f"n_basis 32, 3000 epochs) on line({N_OP_BIG}), B={BATCH_OP_BIG}, "
        f"f32: {t_op:.3f} s host, {1e3 * t_op / 3000:.3f} ms an epoch, "
        f"final loss {float(losses[-1]):.3e}; inference at "
        f"B={BATCH_OP_BIG}: {infer.mean_ms:.4f} ms a call, chained "
        f"[{card}]")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("phase 30 train_operator: loss not finite")

    mesh = FEMesh.line(32, dtype=f32, device=dev)
    counts = reset_all_launches()
    t1 = time.perf_counter()
    _, u_fn, losses = train_collocation(
        mesh, lambda x: math.pi ** 2 * torch.sin(math.pi * x),
        generator=torch.Generator().manual_seed(42), **COL_GATE)
    torch.cuda.synchronize()
    t_col = time.perf_counter() - t1
    xs = torch.linspace(0.05, 0.95, 19, device=dev)[:, None]
    err = float((u_fn(xs) - torch.sin(math.pi * xs[:, 0])).abs().max())
    drop = float(losses[-1] / losses[0])
    log(f"phase 30 train_collocation (line(32), hidden 32, 2 layers, 64 "
        f"points, 1500 epochs, f32): max error vs sin(πx) {err:.4f}, loss "
        f"ratio last/first {drop:.2e}; {t_col:.3f} s host [{card}]")
    if not (err < 0.02 and drop < 1e-2):
        raise AssertionError(f"phase 30 train_collocation: error {err:.4f},"
                             f" loss ratio {drop:.2e}")
    mesh = FEMesh.rectangle(32, 32, dtype=f32, device=dev)
    t1 = time.perf_counter()
    _, _, losses = train_collocation(
        mesh, lambda x: 2 * math.pi ** 2 * torch.sin(math.pi * x[:, 0])
        * torch.sin(math.pi * x[:, 1]))
    torch.cuda.synchronize()
    t_col = time.perf_counter() - t1
    check_only(counts, {}, "phase 30 train_collocation (no kernel)")
    log(f"phase 30 train_collocation at the defaults (hidden 64, 3 layers, "
        f"256 points, 2000 epochs) on rectangle(32, 32), f32: {t_col:.3f} s "
        f"host, {1e3 * t_col / 2000:.3f} ms an epoch, loss ratio "
        f"{float(losses[-1] / losses[0]):.2e} [{card}]")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("phase 30 train_collocation: loss not finite")
    log(f"phase 30: {time.perf_counter() - t0:.1f} s")


N_HALO, BATCH_HALO, HALO_ITERS = 64, 64, 256   # config 4's 64², B = 64
HALO_STEPS, HALO_LR = 3, 0.05
N_HALO3, BATCH_HALO3, HALO3_ITERS = 32, 128, 100
HALO_TOL = 1e-5          # the halo solves against the one-process solves
N_PIPE, BATCH_PIPE, PIPE_H, PIPE_DT, PIPE_MICRO = 64, 4096, 50, 2e-3, 4
MOE_E, MOE_DIN, MOE_HIDDEN, MOE_LAYERS, BATCH_MOE = 8, 16, 64, 3, 4096
PIPE_F64_TOL = 1e-10     # the pipeline against rollout_batched in f64
PIPE_F32_TOL = 1e-3      # and in f32, where the sums run in other orders
MOE_TOL = 1e-5
GOLDEN_N, GOLDEN_TOL = 32, 1e-4   # tests/test_debug.py's problem, bound


def k2_entry(torch, name, dB, eB, F0, launches, what, card):
    """The kernels-line entry of K2 at one path's shape: the block route's
    kernel time a call (profiler), its plain version's, the library's
    (``torch.linalg.solve`` on the densified systems), the error against
    the f64 plain version, and the bound."""
    from difffe_tpu_torch.ops import tridiag as ttri
    from difffe_tpu_torch.ops.kernels import tridiag_kernel as tk

    B, n = F0.shape
    with torch.no_grad():
        u_k = tk.tridiag_solve_kernel(dB, eB, F0)
        u_64 = ttri.tridiag_solve(dB.double(), eB.double(), F0.double())
    max_abs = float((u_k.double() - u_64).abs().max())
    ms = device_ms(torch, lambda c: tk.tridiag_solve_kernel(dB, eB, c), F0,
                   20, "pcr_kernel", launched=lambda: tk.launches["pcr_block"])
    plain_ms = device_ms(torch, lambda c: ttri.tridiag_solve(dB, eB, c), F0,
                         20)
    T = (torch.diag_embed(dB) + torch.diag_embed(eB, 1)
         + torch.diag_embed(eB, -1))
    if T.ndim == 2:
        lib_ms = device_ms(torch, lambda c: torch.linalg.solve(T, c.T).T,
                           F0, 2)
    else:
        lib_ms = device_ms(
            torch, lambda c: torch.linalg.solve(T, c[..., None])[..., 0],
            F0, 2)
    ops = B * n * (K2_OPS_PER_ROW_SWEEP * math.ceil(math.log2(n)) + 1)
    # the bands are read once whether shared or per scenario
    band_rows = 1 if dB.ndim == 1 else B
    nbytes = ((2 * n - 1) * band_rows + 2 * n * B) * 4
    b_ms, b_by = bound(ops, nbytes)
    log(f"{what} K2 at the path's shape (n={n}, B={B}, f32, block route, "
        f"{'shared' if band_rows == 1 else 'batched'} bands), kernel time a "
        f"call (profiler): {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), plain "
        f"{plain_ms:.4f} ms, torch.linalg.solve {lib_ms:.4f} ms; max abs "
        f"err vs f64 plain {max_abs:.3e} [{card}]")
    replaces = f"{JAX_K2}:80 (_pcr_pallas_padded), :161 (_pcr_pallas_T)"
    return kernel_entry(name, K2_SOURCE, replaces, launches, max_abs, ms,
                        plain_ms, ops, nbytes, lib_ms)


def sharded_run(torch, build, mesh, f, u_data, steps):
    """``steps`` Adam steps of an inversion step from ``build()`` (init_fn,
    step_fn) from log κ = 0; (log κ, stacked losses, optimizer, host
    seconds of the first step)."""
    init_fn, step_fn = build()
    log_k, opt = init_fn(torch.zeros(f.shape[0], mesh.n_elements))
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        log_k, opt, loss = step_fn(log_k, opt, f, u_data)
        losses.append(loss)
        if i == 0:
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
    return log_k, torch.stack(losses), opt, t_first


def run_parallel(torch, dev, card):
    """Phases 31-33: the parallel layer at world size 1 on NCCL; returns
    K2's entries at the sharded step's and the pipeline's shapes."""
    import tempfile

    import torch.distributed as dist

    from difffe_tpu_torch.control.heat import (heat_system_tridiag,
                                               rollout_batched)
    from difffe_tpu_torch.entry import dryrun_multichip, entry
    from difffe_tpu_torch.inverse import recover_kappa_field
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.models.neural import init_mlp
    from difffe_tpu_torch.ops import tridiag as ttri
    from difffe_tpu_torch.ops.kernels import tridiag_kernel as tk
    from difffe_tpu_torch.ops.pcg import batched_dot
    from difffe_tpu_torch.ops.stencil import (StructuredGrid,
                                              solve_poisson_structured)
    from difffe_tpu_torch.ops.stencil3d import (StructuredGrid3,
                                                solve_poisson_structured_3d)
    from difffe_tpu_torch.parallel import (make_device_mesh,
                                           make_halo_solver,
                                           make_inversion_step,
                                           make_inversion_step_shard_map,
                                           moe_apply, multihost,
                                           pipelined_rollout,
                                           route_by_bucket)
    from difffe_tpu_torch.parallel.expert import mlp_bank
    from difffe_tpu_torch.parallel.halo3d import make_halo_solver_3d
    from difffe_tpu_torch.solver import solve_poisson, solve_poisson_batched
    from difffe_tpu_torch.utils import CheckpointManager, golden_compare

    f32, f64 = torch.float32, torch.float64
    entries = []

    # -- phase 31: multihost and sharding, BASELINE.json config 2
    t0 = time.perf_counter()
    multihost.initialize(device="cuda", timeout_s=120.0)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"the group is {dist.get_backend()} at world "
                             f"size {dist.get_world_size()}")
    dmesh = make_device_mesh()
    pings = (multihost.HealthCheck(60.0).ping(dmesh),
             multihost.HealthCheck(60.0).ping())
    gen = torch.Generator(device=dev).manual_seed(31)
    n = N_1D + 1
    dB, eB = k2_bands(torch, "fem", n, BATCH_1D, gen, dev)
    dB, eB = dB.float().contiguous(), eB.float().contiguous()
    c = torch.randn(BATCH_1D, n, generator=gen, device=dev)
    t1 = time.perf_counter()
    for _ in range(100):
        c = tk.tridiag_solve_kernel(dB, eB, c)
        c = c / c.abs().amax(dim=-1, keepdim=True)
    ready = multihost.timed_block_until_ready(c, 60.0)
    log(f"phase 31 NCCL at world size 1: HealthCheck.ping over the mesh and "
        f"the default group {pings}; timed_block_until_ready on 100 chained "
        f"K2 solves {ready} after {time.perf_counter() - t1:.3f} s [{card}]")
    if not (all(pings) and ready):
        raise AssertionError("phase 31: a ping or the timed wait failed")

    # phase 14's data: per-element log κ, recovered by both variants
    mesh = FEMesh.line(N_1D, dtype=f32, device=dev)
    g0 = torch.Generator(device=dev).manual_seed(0)
    x = mesh.nodes[:, 0]
    k_true = 1.2 + 0.6 * torch.rand(BATCH_1D, N_1D, generator=g0, device=dev)
    kk = 1.0 + (torch.arange(BATCH_1D, device=dev) % 4)
    f = torch.sin(kk[:, None] * math.pi * x) + 1.5
    variants = {
        "make_inversion_step": lambda: make_inversion_step(
            mesh, dmesh, lr=LR_1D, method="tridiag_pallas")[:2],
        "make_inversion_step_shard_map": lambda: make_inversion_step_shard_map(
            mesh, dmesh, lr=LR_1D, method="tridiag_pallas")}
    runs = {}
    for name, build in variants.items():
        counts = reset_all_launches()
        t1 = time.perf_counter()
        with torch.no_grad():
            u_data = solve_poisson_batched(mesh, k_true, f,
                                           method="tridiag_pallas")
        log_k, losses, opt, t_first = sharded_run(torch, build, mesh, f,
                                                  u_data, STEPS_1D)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t1
        launched = dict(tk.launches)
        check_only(counts, {"tridiag_kernel": {"pcr_block": 1 + 2 * STEPS_1D}},
                   f"phase 31 {name} (u_data and {STEPS_1D} steps, block "
                   f"route)")
        h0, h1 = float(losses[0]), float(losses[-1])
        log(f"phase 31 {name}: n={n} B={BATCH_1D} {STEPS_1D} Adam steps "
            f"lr={LR_1D} on K2: loss {h0:.6e} -> {h1:.6e} ({h0 / h1:.1f}x), "
            f"{t_run:.3f} s host with u_data (the first step "
            f"{t_first:.3f} s), {1e3 * t_run / STEPS_1D:.3f} ms a step; K2 "
            f"launches {launched} [{card}]")
        if not (bool(torch.isfinite(losses).all()) and h1 < 1e-3 * h0):
            raise AssertionError(f"phase 31 {name}: the misfit fell "
                                 f"{h0 / h1:.1f}x, not 1e3x")
        runs[name] = (log_k.detach().clone(), losses, launched, opt)
    (lk_a, loss_a, launched_a, opt_a), (lk_b, loss_b, _, _) = runs.values()
    _, hist = recover_kappa_field(mesh, f, u_data, adam_steps=STEPS_1D,
                                  lr=LR_1D, method="tridiag_pallas")
    e_lk, e_loss, e_rec = (rel_err(lk_b, lk_a), rel_err(loss_b, loss_a),
                           rel_err(loss_a, hist))
    log(f"phase 31 the two variants: log kappa rel err {e_lk:.3e}, losses "
        f"{e_loss:.3e}; the losses against recover_kappa_field's {e_rec:.3e}")
    if not (e_lk <= 1e-6 and e_loss <= 1e-6 and e_rec <= 1e-5):
        raise AssertionError("phase 31: the sharded steps disagree")
    profile_split(torch, lambda: sharded_run(
        torch, variants["make_inversion_step"], mesh, f, u_data, STEPS_1D),
        "phase 31", card, what=f"make_inversion_step loop ({STEPS_1D} "
                               f"steps, B={BATCH_1D})", cpu=False)

    t1 = time.perf_counter()
    fn, args = entry()
    u_entry = fn(*args)
    u_plain = solve_poisson_batched(FEMesh.line(128, dtype=f32, device=dev),
                                    *args, method="tridiag",
                                    kappa_batched=True)
    e_entry = rel_err(u_entry, u_plain)
    dryrun_multichip(1)
    log(f"phase 31 entry(): {tuple(u_entry.shape)} on K2, rel err vs the "
        f"plain route {e_entry:.3e}; dryrun_multichip(1) ok "
        f"({time.perf_counter() - t1:.2f} s)")
    if not (bool(torch.isfinite(u_entry).all()) and e_entry <= 1e-5):
        raise AssertionError("phase 31 entry(): K2 disagrees")
    entries.append(k2_entry(
        torch, "tridiag_pcr_sharded", dB, eB,
        torch.randn(BATCH_1D, n, generator=gen, device=dev),
        launched_a["pcr_block"], "phase 31", card))
    log(f"phase 31: {time.perf_counter() - t0:.1f} s")

    # -- phase 32: halo solvers, config 4 (64², B = 64) and a 32³ box
    t0 = time.perf_counter()
    grid = StructuredGrid.unit(N_HALO, N_HALO)
    gen = torch.Generator(device=dev).manual_seed(32)
    shape = (BATCH_HALO, N_HALO, N_HALO)
    kl_t = 1.0 + torch.rand(shape, generator=gen, device=dev)
    ku_t = 1.0 + torch.rand(shape, generator=gen, device=dev)
    fh = 1.0 + torch.rand((BATCH_HALO,) + grid.node_shape, generator=gen,
                          device=dev)
    gh = torch.zeros(grid.node_shape, device=dev)
    solve = make_halo_solver(dmesh, grid, maxiter=HALO_ITERS,
                             batch_axis="dp")
    counts = reset_all_launches()
    with torch.no_grad():
        u_data = solve((kl_t, ku_t), fh, gh)
    lkl = torch.zeros(shape, device=dev, requires_grad=True)
    lku = torch.zeros(shape, device=dev, requires_grad=True)
    opt = torch.optim.Adam([lkl, lku], lr=HALO_LR, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    t1 = time.perf_counter()
    for step in range(HALO_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = ((solve((lkl.exp(), lku.exp()), fh, gh) - u_data) ** 2).mean()
        loss.backward()
        if step == 0:
            first = (loss.detach(), lkl.grad.clone(), lku.grad.clone())
        opt.step()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    t_halo = time.perf_counter() - t1
    check_only(counts, {}, "phase 32 (the halo solves are plain PyTorch)")
    kl0 = torch.zeros(shape, device=dev, requires_grad=True)
    ku0 = torch.zeros(shape, device=dev, requires_grad=True)
    ref = ((solve_poisson_structured(grid, (kl0.exp(), ku0.exp()), fh, gh,
                                     maxiter=HALO_ITERS,
                                     dot=batched_dot(2)) - u_data) ** 2).mean()
    ref.backward()
    errs = (rel_err(first[0], ref.detach()), rel_err(first[1], kl0.grad),
            rel_err(first[2], ku0.grad))
    log(f"phase 32 make_halo_solver {N_HALO}x{N_HALO} B={BATCH_HALO} "
        f"maxiter={HALO_ITERS} f32: {HALO_STEPS} Adam steps, loss "
        + " -> ".join(f"{v:.6e}" for v in losses)
        + f", {1e3 * t_halo / HALO_STEPS:.1f} ms a step (a forward and an "
          f"adjoint halo CG); the first loss and kappa gradients against "
          f"solve_poisson_structured(dot=batched_dot(2)): rel err "
          + ", ".join(f"{e:.3e}" for e in errs) + f" [{card}]")
    if not (max(errs) <= HALO_TOL and losses[-1] < losses[0]):
        raise AssertionError(f"phase 32 2D halo: errors {errs}, losses "
                             f"{losses}")
    profile_split(torch, lambda: ((solve((lkl.exp(), lku.exp()), fh, gh)
                                   - u_data) ** 2).mean().backward(),
                  "phase 32", card, what="2D halo value and gradient",
                  cpu=False)
    del kl_t, ku_t, fh, u_data, lkl, lku, opt, kl0, ku0, first
    torch.cuda.empty_cache()

    grid3 = StructuredGrid3.unit(N_HALO3, N_HALO3, N_HALO3)
    k3 = 1.0 + torch.rand(BATCH_HALO3, grid3.n_elements, generator=gen,
                          device=dev)
    f3 = 1.0 + torch.rand((BATCH_HALO3,) + grid3.node_shape, generator=gen,
                          device=dev)
    g3 = torch.zeros(grid3.node_shape, device=dev)
    solve3 = make_halo_solver_3d(dmesh, grid3, maxiter=HALO3_ITERS,
                                 batch_axis="dp")
    vals, grads = [], []
    counts = reset_all_launches()
    for which in ("halo", "single"):
        k = k3.clone().requires_grad_()
        t1 = time.perf_counter()
        u = (solve3(k, f3, g3) if which == "halo" else
             solve_poisson_structured_3d(grid3, k, f3, g3,
                                         maxiter=HALO3_ITERS,
                                         dot=batched_dot(3)))
        val = (u ** 2).mean()
        val.backward()
        torch.cuda.synchronize()
        if which == "halo":
            t_h3 = time.perf_counter() - t1
        vals.append(val.detach())
        grads.append(k.grad)
        del u, k
    check_only(counts, {}, "phase 32 3D (plain PyTorch)")
    errs = (rel_err(vals[0], vals[1]), rel_err(grads[0], grads[1]))
    log(f"phase 32 make_halo_solver_3d {N_HALO3}^3 B={BATCH_HALO3} "
        f"maxiter={HALO3_ITERS} f32: value and kappa gradient in "
        f"{t_h3:.3f} s; against solve_poisson_structured_3d("
        f"dot=batched_dot(3)): rel err {errs[0]:.3e}, {errs[1]:.3e} [{card}]")
    if not max(errs) <= HALO_TOL:
        raise AssertionError(f"phase 32 3D halo: errors {errs}")
    del k3, f3, grads
    torch.cuda.empty_cache()
    log(f"phase 32: {time.perf_counter() - t0:.1f} s")

    # -- phase 33: the pipeline (config 3), the expert bank, checkpoints
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(33)
    n = N_PIPE + 1
    inputs = {"kappa": 0.8 + 0.8 * torch.rand(N_PIPE, generator=gen,
                                              device=dev, dtype=f64),
              "u0": torch.rand(BATCH_PIPE, n, generator=gen, device=dev,
                               dtype=f64),
              "f": torch.rand(PIPE_H, BATCH_PIPE, n, generator=gen,
                              device=dev, dtype=f64)}
    w = torch.randn(BATCH_PIPE, n, generator=gen, device=dev, dtype=f64)

    def rollout_run(dtype, pipelined, method="auto"):
        m = FEMesh.line(N_PIPE, dtype=dtype, device=dev)
        leaves = [inputs[k].to(dtype).detach().clone().requires_grad_()
                  for k in ("kappa", "u0", "f")]
        if pipelined:
            u_final, cost = pipelined_rollout(
                dmesh, m, *leaves, PIPE_DT, n_micro=PIPE_MICRO,
                cost_fn=lambda u: (u * u).sum())
        else:
            traj = rollout_batched(m, *leaves, PIPE_DT, method=method)
            u_final, cost = traj[-1], (traj * traj).sum()
        (cost + (u_final * w.to(dtype)).sum()).backward()
        return [u_final.detach(), cost.detach()] + [t.grad for t in leaves]

    counts = reset_all_launches()
    t1 = time.perf_counter()
    pipe = rollout_run(f32, True)
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t1
    launched_pipe = dict(tk.launches)
    want = 2 * PIPE_MICRO * PIPE_H
    check_only(counts, {"tridiag_kernel": {"pcr_block": want}},
               f"phase 33 pipelined_rollout ({PIPE_MICRO} microbatches of "
               f"{BATCH_PIPE // PIPE_MICRO}: {want} block-route launches)")
    ref32 = rollout_run(f32, False)
    ref64 = rollout_run(f64, False, "tridiag")
    pipe64 = rollout_run(f64, True)
    what = ("final state", "cost", "kappa gradient", "u0 gradient",
            "f_seq gradient")
    e64 = [rel_err(a, c) for a, c in zip(pipe64, ref64)]
    e32 = [(rel_err(a, c), rel_err(b, c), rel_err(a, b))
           for a, b, c in zip(pipe, ref32, ref64)]
    log(f"phase 33 pipelined_rollout line({N_PIPE}) B={BATCH_PIPE} "
        f"H={PIPE_H} dt={PIPE_DT} n_micro={PIPE_MICRO} depth 1: "
        f"{t_pipe:.3f} s host for the f32 value and gradients; K2 launches "
        f"{launched_pipe}; f64 on K2 against rollout_batched f64: "
        + ", ".join(f"{wh} {e:.3e}" for wh, e in zip(what, e64))
        + "; f32 against rollout_batched f64 (rollout_batched f32; the "
          "two f32 runs' difference): "
        + ", ".join(f"{wh} {a:.3e} ({b:.3e}; {d:.3e})"
                    for wh, (a, b, d) in zip(what, e32)) + f" [{card}]")
    # the same function in f64; in f32 the pipeline sums the κ gradient
    # over microbatches and steps in another order than the rollout
    if not (max(e64) <= PIPE_F64_TOL
            and max(d for _, _, d in e32) <= PIPE_F32_TOL
            and all(bool(torch.isfinite(t).all()) for t in pipe)):
        raise AssertionError(f"phase 33 pipelined_rollout: f64 {e64}, "
                             f"f32 {e32}")
    profile_split(torch, lambda: rollout_run(f32, True), "phase 33", card,
                  what="pipelined_rollout value and gradients", cpu=False)
    del pipe, ref32, ref64, pipe64
    torch.cuda.empty_cache()
    mesh_p = FEMesh.line(N_PIPE, dtype=f32, device=dev)
    dP, eP = heat_system_tridiag(mesh_p, inputs["kappa"].float(), PIPE_DT)
    dP, eP, _, _ = ttri.dirichlet_elimination(mesh_p, dP, eP)
    entries.append(k2_entry(
        torch, "tridiag_pcr_pipeline", dP.contiguous(), eP.contiguous(),
        torch.rand(BATCH_PIPE // PIPE_MICRO, n, generator=gen, device=dev),
        launched_pipe["pcr_block"], "phase 33", card))

    # the expert bank: 8 experts of 64 × 3 tanh MLPs over 4096 scenarios
    cpu_gen = torch.Generator().manual_seed(33)
    nets = [init_mlp(cpu_gen, MOE_DIN, MOE_HIDDEN, MOE_LAYERS, device=dev)
            for _ in range(MOE_E)]
    params, apply_fn = mlp_bank(nets)
    X = torch.randn(BATCH_MOE, MOE_DIN, generator=gen, device=dev)
    stat = torch.rand(BATCH_MOE, generator=gen, device=dev)
    bounds = torch.quantile(stat, torch.linspace(0, 1, MOE_E + 1,
                                                 device=dev)[1:-1])
    ids = route_by_bucket(stat, bounds)
    counts = reset_all_launches()
    t1 = time.perf_counter()
    with torch.no_grad():
        Y, dropped = moe_apply(params, X, ids, apply_fn)
        Y_mesh, dropped_mesh = moe_apply(params, X, ids, apply_fn,
                                         dmesh=dmesh)
    torch.cuda.synchronize()
    t_moe = time.perf_counter() - t1
    check_only(counts, {}, "phase 33 moe_apply (plain PyTorch)")
    with torch.no_grad():
        Y_ref = torch.zeros_like(Y)
        for e, net in enumerate(nets):
            rows = ids == e
            Y_ref[rows, 0] = net(X[rows])
    e_moe, e_mesh = rel_err(Y, Y_ref), rel_err(Y_mesh, Y)
    log(f"phase 33 moe_apply B={BATCH_MOE} E={MOE_E} experts of "
        f"{MOE_HIDDEN} x {MOE_LAYERS} on {MOE_DIN} inputs: dropped "
        f"{int(dropped)} (with the mesh {int(dropped_mesh)}), rel err vs a "
        f"per-expert loop {e_moe:.3e}, with the mesh vs without "
        f"{e_mesh:.3e}, both calls {1e3 * t_moe:.1f} ms [{card}]")
    if not (int(dropped) == int(dropped_mesh) == 0 and e_moe <= MOE_TOL
            and e_mesh <= MOE_TOL):
        raise AssertionError("phase 33 moe_apply disagrees")

    # a CUDA Adam state through CheckpointManager, bit for bit
    state = {"log_k": lk_a, "opt": opt_a.state_dict()}
    with tempfile.TemporaryDirectory() as ck_dir:
        mgr = CheckpointManager(ck_dir, async_save=True)
        mgr.save(STEPS_1D, state)
        back = mgr.restore(mgr.latest_step(), template=state)
    pairs = [(back["log_k"], state["log_k"])] + [
        (back["opt"]["state"][i][k], v)
        for i, st in state["opt"]["state"].items() for k, v in st.items()]
    same = all(a.device == b.device and a.dtype == b.dtype
               and torch.equal(a, b) for a, b in pairs)
    restored = torch.optim.Adam([back["log_k"].clone().requires_grad_()],
                                lr=LR_1D)
    restored.load_state_dict(back["opt"])
    log(f"phase 33 CheckpointManager (async) of the phase 31 Adam state: "
        f"{len(pairs)} tensors (the moments on the card) restored bit for bit: {same}")
    if not same:
        raise AssertionError("phase 33: the restored state differs")

    # tests/test_debug.py's problem and bound, the solve on K2
    mesh_g = FEMesh.line(GOLDEN_N, dtype=f32, device=dev)
    worst = golden_compare(
        lambda k, f_: solve_poisson(mesh_g.astype(f_.dtype), k, f_,
                                    method="tridiag_pallas"),
        torch.tensor(1.0, device=dev),
        torch.sin(torch.linspace(0, 3, GOLDEN_N + 1, device=dev)))
    log(f"phase 33 golden_compare of the 1D solve on K2 (line({GOLDEN_N}), "
        f"kappa 1, f = sin(linspace(0, 3))), f32 against f64: worst "
        f"elementwise rel deviation {worst:.3e} [{card}]")
    if not worst <= GOLDEN_TOL:
        raise AssertionError(f"phase 33 golden_compare: {worst:.3e}")
    log(f"phase 33: {time.perf_counter() - t0:.1f} s")
    dist.destroy_process_group()
    return entries


def timeit_chained_min(fn, x0, length=4):
    """Best chained ms per call of one function."""
    from difffe_tpu_torch.utils.profiling import timeit_chained

    return timeit_chained(fn, x0, length=length, repeats=3).min_s * 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the general-mesh path's perturbation "
                             "and data")
    seed = parser.parse_args().seed
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from difffe_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: what runs where
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"card: {card}")

    # -- phase 2: build
    t0 = time.perf_counter()
    lib = _build.load_library()
    log(f"phase 2 build: {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s ({lib._name})")

    t0 = time.perf_counter()
    kernels = run_1d(torch, dev, card)
    log(f"1D path, phases 3-6: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += run_2d(torch, dev, card)
    log(f"2D path, phases 7-9: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += run_3d(torch, dev, card)
    log(f"3D path, phases 10-12: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += run_facade_1d(torch, dev, card)
    log(f"1D facade path, phases 13-16: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += run_fused_1d(torch, dev, card)
    log(f"fused 1D path, phases 17-20: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += run_general(torch, dev, card, seed)
    log(f"general-mesh path, phases 21-23: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += run_ablation(torch, dev, card)
    log(f"K7 ablation path (P2), phase 24: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += run_structured(torch, dev, card)
    log(f"structured solver path, phases 25-27: "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += run_control(torch, dev, card)
    run_surrogates(torch, dev, card)
    log(f"control and model path, phases 28-30: "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += run_parallel(torch, dev, card)
    log(f"parallel path, phases 31-33: {time.perf_counter() - t0:.1f} s")

    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
