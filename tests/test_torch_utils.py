"""The PyTorch port's utilities and exports against the JAX package:
faults F2 and F3 (``FEMesh.dirichlet_items`` and ``FEMesh.astype`` on the
three factory meshes; the utilities' and the parallel layer's names),
``CheckpointManager`` (torch.save/torch.load: the cases of
tests/test_utils.py's TestCheckpoint — a round trip, an async round trip,
garbage collection, a missing step, and a resumed Adam trajectory that
repeats the uninterrupted one bit for bit), and the debug guards and
profiling helpers (the cases of tests/test_debug.py and
tests/test_utils.py's TestProfiling, TestTraceCapture and
TestScalingHarness), on the CPU."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffe_tpu.parallel
import difffe_tpu.utils
import difffe_tpu_torch.parallel
import difffe_tpu_torch.utils
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu_torch.inverse import _adam
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops.assembly import assemble_stiffness_dense
from difffe_tpu_torch.parallel.multihost import scaling_efficiency
from difffe_tpu_torch.solver import solve_poisson, solve_poisson_batched
from difffe_tpu_torch.utils import (CheckpointManager, TimingResult,
                                    check_deterministic, golden_compare,
                                    nan_guard, roofline, timeit_torch, trace)
from torch_parity import jax_mesh

torch.set_num_threads(1)

MESHES = {
    "line": ("line", (12,), {"bc_left": 0.4, "bc_right": -0.1}),
    "rectangle": ("rectangle", (4, 3), {}),
    "box": ("box", (2, 3, 2), {}),
}


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_dirichlet_items_and_astype(kind):
    name, args, kw = MESHES[kind]
    jm = jax_mesh(getattr(JMesh, name), *args, dtype=jnp.float64, **kw)
    tm = getattr(TMesh, name)(*args, dtype=torch.float64, device="cpu", **kw)
    assert tm.dirichlet_items() == jm.dirichlet_items()
    assert all(type(i) is int and type(v) is float
               for i, v in tm.dirichlet_items())

    j32, t32 = jm.astype(jnp.float32), tm.astype(torch.float32)
    for field in ("nodes", "bc_mask", "bc_values"):
        a, b = getattr(t32, field), getattr(j32, field)
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        assert a.device == tm.device
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t32.elements is tm.elements
    assert (t32.grid is None) == (j32.grid is None)
    assert t32.grid == tm.grid


def test_utils_exports():
    """Every name of the JAX utilities, ``timeit_jax`` as
    ``timeit_torch``."""
    names = [("timeit_torch" if n == "timeit_jax" else n)
             for n in difffe_tpu.utils.__all__]
    assert difffe_tpu_torch.utils.__all__ == names
    namespace = {}
    exec(f"from difffe_tpu_torch.utils import {', '.join(names)}",
         namespace)
    assert all(namespace[n] is getattr(difffe_tpu_torch.utils, n)
               for n in names)


def test_parallel_exports():
    assert difffe_tpu_torch.parallel.__all__ == difffe_tpu.parallel.__all__
    for name in difffe_tpu_torch.parallel.__all__:
        assert callable(getattr(difffe_tpu_torch.parallel, name)), name


def _state():
    g = torch.Generator().manual_seed(3)
    return {"params": [torch.arange(5.0), torch.ones(2, 3)],
            "step": torch.tensor(7),
            "gen": g.get_state(),
            "meta": ("adam", 0.1, None)}


def _assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_save_restore_roundtrip(tmp_path, async_save):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=async_save)
    state = _state()
    mgr.save(7, state)
    state["params"][0].add_(1.0)       # the snapshot is taken at save
    restored = mgr.restore(7, template=state)   # waits for an async write
    state["params"][0].sub_(1.0)
    _assert_same(restored, state)
    assert mgr.latest_step() == 7
    mgr.save(8, state)
    mgr.wait_until_finished()
    assert mgr.steps() == [7, 8]


def test_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, {"x": torch.tensor(s)})
    assert mgr.steps() == [3, 4]


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    with pytest.raises(FileNotFoundError):
        mgr.restore(99)


def test_resume_training_reproduces_trajectory(tmp_path):
    """Kill-and-resume from step 10 of 20 repeats the uninterrupted run:
    the parameter and the Adam state restored from the checkpoint."""
    mesh = TMesh.line(16, dtype=torch.float64, device="cpu")
    f = torch.ones(mesh.n_nodes, dtype=torch.float64)
    u_data = solve_poisson(mesh, 2.0, f)

    def run(k, opt, steps):
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            ((solve_poisson(mesh, k.abs(), f) - u_data) ** 2).mean().backward()
            opt.step()

    k = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    run(k, _adam([k], 0.1), 20)

    k2 = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    opt2 = _adam([k2], 0.1)
    run(k2, opt2, 10)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(10, {"k": k2, "opt": opt2.state_dict()})
    rest = mgr.restore(10, template={"k": k2, "opt": opt2.state_dict()})
    k3 = rest["k"].clone().requires_grad_()
    opt3 = _adam([k3], 0.1)
    opt3.load_state_dict(rest["opt"])
    run(k3, opt3, 10)
    assert float(k3.detach()) == float(k.detach()) != 1.0


def test_nan_guard_raises():
    x = torch.tensor([0.0, 1.0])
    with nan_guard():
        y = x * 2.0                     # no NaN: runs
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.log(x - 1.0)
    assert torch.isnan(torch.log(x - 1.0)).any()   # outside: no check


def test_deterministic_and_golden_compare():
    mesh = TMesh.line(20, dtype=torch.float64, device="cpu")
    x = mesh.nodes[:, 0]
    kappa = torch.linspace(0.5, 2.0, 8, dtype=torch.float64)
    f = (torch.sin(math.pi * x) + 1.0).expand(8, mesh.n_nodes)

    def solve(k, f_):
        m = mesh.astype(k.dtype)
        return solve_poisson_batched(m, k, f_, kappa_batched=True)

    assert check_deterministic(solve, kappa, f)
    assert check_deterministic(
        lambda: assemble_stiffness_dense(mesh, kappa[:, None].expand(
            8, mesh.n_elements)))
    calls = iter([torch.zeros(2), torch.ones(2)])
    assert not check_deterministic(lambda: next(calls))
    worst = golden_compare(solve, kappa, f)
    assert 1e-9 < worst < 1e-5          # f32 against f64


def test_roofline_classification():
    t = TimingResult(mean_s=1e-3, min_s=1e-3, iters=1)
    r_mem = roofline(t, flops=1e6, bytes_moved=1e9)
    assert r_mem.bound == "memory"
    assert r_mem.bandwidth_fraction == pytest.approx(1e12 / 3.35e12)
    r_cmp = roofline(t, flops=1e12, bytes_moved=1e6, dtype="f32")
    assert r_cmp.bound == "compute"
    assert r_cmp.flops_fraction == pytest.approx(1e3 / 67.0)
    assert roofline(t, 1e12, 1e6, dtype="bf16").flops_fraction == \
        pytest.approx(1e3 / 989.0)
    with pytest.raises(ValueError):
        roofline(t, 1.0, 1.0, chip="tpu_v5e")


def test_timing_trace_and_scaling(tmp_path):
    t = timeit_torch(lambda x: x * 2.0, torch.ones(128), iters=5)
    assert t.mean_s > 0 and t.min_s > 0 and t.throughput(128) > 0
    logdir = tmp_path / "prof"
    with trace(str(logdir)):
        torch.ones(64).mul(2.0)
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert any("mul" in e.get("name", "") for e in events)
    res = scaling_efficiency(lambda x: x.sum(),
                             lambda n: (torch.ones(16 * n),), [1, 2],
                             iters=2)
    assert set(res) == {1, 2} and res[1][1] == pytest.approx(1.0)
