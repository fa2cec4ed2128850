"""The cluster routes' plans on the CPU: K3a's, K3b's, K4a's and K4b's
(``stencil_cg_kernel.cluster_plan``) and K8s's
(``ell_kernel.ell_cluster_plan``).

A plan is plain Python: which route a shape takes, how many blocks a
cluster has, what each block holds.  These cases run it on every shape
``chip_smoke.py`` holds the kernels to (its K3_CASES and K4_CASES, and
the general-mesh shapes of phases 21-23), with float32 and bfloat16
planes, at the H100's 232 448 bytes a block, and on shapes past the
cluster route's reach; K8s's plan also on float64 and tol-gated solves.
No JAX, no card.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from difffe_tpu_torch.ops.kernels import ell_kernel as k8
from difffe_tpu_torch.ops.kernels import stencil3d_cg_kernel as k4
from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as sk

LIMIT = 232_448          # H100: shared memory a block may opt in to
SM_BYTES = LIMIT + 1024  # an SM's shared memory; 1 KB kept for each block


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _smoke()
# (nodes, coefficient planes): K3b's n² grids have (n+1)² nodes and 5
# planes, K4b's boxes (nx+1)(ny+1)(nz+1) nodes and 7
SHAPES = ([((n + 1) ** 2, 5, f"{n}x{n}") for n, _ in _SMOKE.K3_CASES]
          + [((nx + 1) * (ny + 1) * (nz + 1), 7, f"{nx}x{ny}x{nz}")
             for nx, ny, nz, _ in _SMOKE.K4_CASES])
ITEMS = [4, 2]
# (nodes, planes, itemsize, name): past 16 blocks' worth
PAST_REACH = [(289 ** 2, 5, 4, "288x288_f32"), (289 ** 2, 5, 2, "288x288_bf16"),
              (49 ** 3, 7, 4, "48x48x48_f32"), (49 ** 3, 7, 2, "48x48x48_bf16")]


def _bytes(nodes, planes, item, c):
    """A cluster-route block's shared memory, counted from
    csrc/cg_cluster.cuh: two p buffers and r in f32 and planes + 1 stored
    planes over ceil(nodes / c) nodes, two 32-float reduction buffers, two
    16-float tables of published partials and two 8-byte mbarriers."""
    chunk = -(-nodes // c)
    return chunk * (12 + (planes + 1) * item) + 4 * (2 * 32 + 2 * 16) + 16


def _per_thread(nodes, planes, item, c):
    """Nodes a thread holds: a block of up to 640 threads when one block
    fills an SM's shared memory, else up to 320."""
    one = 2 * (_bytes(nodes, planes, item, c) + 1024) > SM_BYTES
    return -(-(-(-nodes // c)) // (640 if one else 320))


def _expected_cluster(nodes, planes, item):
    """The plan's stated rule, restated: the smallest C whose block fits
    (its bytes, and at most 8 nodes a thread), else 0 (the workspace
    route)."""
    fits = [c for c in (1, 2, 4, 8, 16)
            if _bytes(nodes, planes, item, c) <= LIMIT
            and _per_thread(nodes, planes, item, c) <= 8]
    return (fits or [0])[0]


@pytest.mark.parametrize("item", ITEMS, ids=["f32", "bf16"])
@pytest.mark.parametrize("nodes,planes,name", SHAPES,
                         ids=[s[2] for s in SHAPES])
def test_plan_follows_its_rule(nodes, planes, name, item):
    plan = sk.cluster_plan(nodes, planes, item, LIMIT)
    want = _expected_cluster(nodes, planes, item)
    if want == 0:       # 48³ in f32: past 16 blocks' worth
        assert plan == sk.workspace_plan(nodes)
        return
    assert plan.route == "cluster", name
    assert plan.cluster == want
    assert plan.block_bytes == _bytes(nodes, planes, item, plan.cluster)
    assert plan.block_bytes <= LIMIT
    assert plan.blocks_per_sm == SM_BYTES // (plan.block_bytes + 1024)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 640
    assert plan.threads <= (640 if plan.blocks_per_sm == 1 else 320)
    assert plan.threads * 8 >= plan.chunk
    # the ranks cover [0, nodes) in order, without overlap or gap
    ranges = plan.ranges()
    assert len(ranges) == plan.cluster
    assert ranges[0][0] == 0 and ranges[-1][1] == nodes
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo <= hi == lo2
    assert all(hi - lo <= plan.chunk for lo, hi in ranges)


@pytest.mark.parametrize("nodes,planes,item,name", PAST_REACH,
                         ids=[s[3] for s in PAST_REACH])
def test_shapes_past_the_cluster_reach_take_the_workspace_route(
        nodes, planes, item, name):
    assert _expected_cluster(nodes, planes, item) == 0
    plan = sk.cluster_plan(nodes, planes, item, LIMIT)
    assert (plan.route, plan.cluster) == ("workspace", 0)
    assert plan == sk.workspace_plan(nodes)


@pytest.mark.parametrize("cluster", sk.CLUSTER_SIZES)
def test_layout_at_every_cluster_size(cluster):
    """12×9×6 (910 nodes) fits every size; 16 ranks of 57 nodes cover it,
    and at 8² (81 nodes) 16 ranks of 6 leave the last two empty."""
    for nodes in (910, 81):
        plan = sk.cluster_layout(nodes, 7, 4, cluster, LIMIT)
        assert plan.chunk == -(-nodes // cluster)
        assert sum(hi - lo for lo, hi in plan.ranges()) == nodes
        per = -(-plan.chunk // 320)     # several blocks share an SM here
        assert plan.threads == 32 * -(-plan.chunk // (32 * per))


def test_layout_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="exceed"):
        sk.cluster_layout(33 ** 3, 7, 4, 4, LIMIT)
    with pytest.raises(ValueError, match="cluster size"):
        sk.cluster_layout(910, 7, 4, 3, LIMIT)


@pytest.mark.parametrize("item", ITEMS, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [(12, 9, 6), (32, 32, 32), (48, 48, 48)],
                         ids=["12x9x6", "32cube", "48cube"])
def test_k4a_takes_k4b_plan(monkeypatch, n, item):
    """K4a (one solve) and K4b (two) share a plan: the same bytes a block;
    32³ in f32 at C = 8, 48³ in f32 on the workspace route."""
    monkeypatch.setattr(k4, "smem_optin", lambda index: LIMIT)
    nx, ny, nz = n
    D = torch.empty(7, 1, 1, 1, 1, dtype={4: torch.float32,
                                           2: torch.bfloat16}[item])
    plan = k4._plan_cg3(D, nz + 1, ny + 1, nx + 1, None)
    nodes = (nx + 1) * (ny + 1) * (nz + 1)
    assert plan == sk.cluster_plan(nodes, 7, item, LIMIT)
    if item == 4 and n[0] >= 32:
        assert (plan.route, plan.cluster) == (
            ("cluster", 8) if n[0] == 32 else ("workspace", 0))
    # a forced plan reaches the op as its cluster size, 0 the workspace
    assert k4._plan_cg3(D, nz + 1, ny + 1, nx + 1,
                        sk.forced_cluster(sk.workspace_plan(nodes))) == \
        sk.workspace_plan(nodes)
    if plan.route == "cluster":
        assert k4._plan_cg3(D, nz + 1, ny + 1, nx + 1,
                            sk.forced_cluster(plan)) == plan


@pytest.mark.parametrize("n,want", [(8, ("cluster", 1)), (64, ("cluster", 1)),
                                    (256, ("cluster", 16)),
                                    (288, ("workspace", 0))],
                         ids=["8", "64", "256", "288"])
def test_k3a_takes_k3b_plan(monkeypatch, n, want):
    """K3a (one solve) and K3b (two) share a plan: the same bytes a block;
    64² at C = 1, 256² at C = 16, 288² past the reach on the workspace
    route."""
    monkeypatch.setattr(sk, "smem_optin", lambda index: LIMIT)
    D = torch.empty(5, 1, 1, 1)
    plan = sk._plan_cg2(D, n + 1, n + 1, None)
    assert plan == sk.cluster_plan((n + 1) ** 2, 5, 4, LIMIT)
    assert (plan.route, plan.cluster) == want
    # a forced plan reaches the op as its cluster size, 0 the workspace
    forced = sk.workspace_plan((n + 1) ** 2)
    assert sk._plan_cg2(D, n + 1, n + 1, sk.forced_cluster(forced)) == forced
    if plan.route == "cluster":
        assert sk._plan_cg2(D, n + 1, n + 1, sk.forced_cluster(plan)) == plan


def _ell_bytes(nodes, Dn, c):
    """A K8s block's shared memory, counted from csrc/ell_cg.cu: two p
    buffers and r, Dn W slots, m + p·diag and M⁻¹ in f32 over
    ceil(nodes / c) nodes, and the cluster body's static 400 bytes."""
    chunk = -(-nodes // c)
    return chunk * (12 + (Dn + 2) * 4) + 4 * (2 * 32 + 2 * 16) + 16


# (nodes, Dn, C the plan must pick, name): the perturbed 8×8 and 64²
# triangulations, the 16³ tet box (14 slots a node), 256² (phase 23)
ELL_SHAPES = [(81, 6, 1, "8x8"), (65 ** 2, 6, 1, "64x64"),
              (17 ** 3, 14, 2, "16cube_tets"), (257 ** 2, 6, 16, "256x256")]
# past 16 blocks' worth (8 nodes a thread of 640 threads, or the bytes),
# or more slots than the kernel's unrolled apply takes
ELL_PAST = [(301 ** 2, 6, "300x300"), (41 ** 3, 14, "40cube_tets"),
            (4913, 17, "17_slots")]


@pytest.mark.parametrize("nodes,Dn,want,name", ELL_SHAPES,
                         ids=[s[3] for s in ELL_SHAPES])
def test_ell_plan_follows_its_rule(nodes, Dn, want, name):
    plan = k8.ell_cluster_plan(nodes, Dn, 4, LIMIT)
    assert (plan.route, plan.cluster) == ("cluster", want)
    assert plan.block_bytes == _ell_bytes(nodes, Dn, want) <= LIMIT
    assert all(_ell_bytes(nodes, Dn, c) > LIMIT
               or -(-nodes // c) > 8 * 640
               for c in sk.CLUSTER_SIZES if c < want)
    assert plan.threads % 32 == 0 and plan.threads * 8 >= plan.chunk
    assert plan.threads <= (640 if plan.blocks_per_sm == 1 else 320)
    ranges = plan.ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == nodes
    # every larger cluster size that fits is laid out by the same count
    for c in sk.CLUSTER_SIZES[sk.CLUSTER_SIZES.index(want):]:
        layout = k8.ell_cluster_layout(nodes, Dn, c, LIMIT)
        assert layout.block_bytes == _ell_bytes(nodes, Dn, c)


@pytest.mark.parametrize("nodes,Dn,name", ELL_PAST,
                         ids=[s[2] for s in ELL_PAST])
def test_ell_shapes_past_reach_take_the_per_iteration_route(nodes, Dn,
                                                             name):
    plan = k8.ell_cluster_plan(nodes, Dn, 4, LIMIT)
    assert plan == k8.per_iteration_plan(nodes)
    assert (plan.route, plan.cluster) == ("per_iteration", 0)
    if Dn > k8.ELL_MAX_SLOTS:
        with pytest.raises(ValueError, match="slots"):
            k8.ell_cluster_layout(nodes, Dn, 16, LIMIT)


@pytest.mark.parametrize("itemsize,tol", [(8, 0.0), (4, 1e-6), (8, 1e-6)],
                         ids=["f64", "f32_tol", "f64_tol"])
def test_ell_float64_and_gated_solves_take_the_per_iteration_route(
        itemsize, tol):
    plan = k8.ell_cluster_plan(65 ** 2, 6, itemsize, LIMIT, tol)
    assert plan == k8.per_iteration_plan(65 ** 2)
