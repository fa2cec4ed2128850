"""K3b's and K4b's plan (``stencil_cg_kernel.cluster_plan``) on the CPU.

The plan is plain Python: which route a shape takes, how many blocks a
cluster has, what each block holds.  These cases run it on every shape
``chip_smoke.py`` holds the kernels to (its K3_CASES and K4_CASES), with
float32 and bfloat16 planes, at the H100's 232 448 bytes a block, and on
shapes past the cluster route's reach.  No JAX, no card.
"""

import importlib.util
from pathlib import Path

import pytest

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
