"""The trace reader and the per-layer metrics' arithmetic on a synthetic
profiler trace whose answers are worked out by hand."""

import types

import pytest

from benchmark import harness, trace, work

NODES = (4096, 65, 65)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _events():
    """One traced unit of 1000 µs: a CG op launching one 400 µs kernel
    (linked by its correlation id), a torch op launching a 100 µs kernel,
    a copy, and a kernel launched before the window that runs into it."""
    return [
        _x("bench.unit", "user_annotation", 0.0, 1000.0),
        _x("difffe::stencil_cg", "cpu_op", 100.0, 50.0,
           **{"Concrete Inputs": ["", "", "", "", "256", ""],
              "Input Dims": [[5, *NODES], list(NODES), list(NODES),
                             list(NODES), [], []]}),
        _x("cudaLaunchKernel", "cuda_runtime", 120.0, 5.0, correlation=7),
        _x("cluster_cg_kernel", "kernel", 130.0, 400.0, tid=7,
           correlation=7),
        _x("aten::add", "cpu_op", 600.0, 20.0),
        _x("cudaLaunchKernel", "cuda_runtime", 605.0, 5.0, correlation=8),
        _x("add_kernel", "kernel", 700.0, 100.0, tid=7, correlation=8),
        _x("Memcpy DtoD", "gpu_memcpy", 790.0, 20.0, tid=7),
        # outside the window: neither counted nor busy
        _x("early_kernel", "kernel", -50.0, 40.0, tid=7, correlation=9),
    ]


def test_window_busy_gaps_and_op_attribution():
    tr = trace.parse({"traceEvents": _events()})
    assert tr.window == (0.0, 1000.0) and tr.units == 1
    assert tr.window_s == pytest.approx(1e-3)
    # busy: [130, 530] and [700, 810] (the copy extends the add)
    assert tr.busy_s == pytest.approx(510e-6)
    assert [(k.name, k.op) for k in tr.kernels] == [
        ("cluster_cg_kernel", "difffe::stencil_cg"), ("add_kernel", None)]
    assert [c.name for c in tr.op_calls] == ["difffe::stencil_cg"]
    gaps = {g[0]: g[1] for g in tr.idle_gaps()}
    # [0,130] and [810,1000] under the unit alone, [530,700] in aten::add
    assert gaps["host outside any op (x2)"] == pytest.approx(320e-6)
    assert gaps["aten::add (x1)"] == pytest.approx(170e-6)
    ops = dict((n, s) for n, s in tr.device_ops())
    assert ops == pytest.approx({"cluster_cg_kernel": 400e-6,
                                 "add_kernel": 100e-6})


def _metric(name, tr, **work_kw):
    ctx = types.SimpleNamespace(trace=tr, cell={}, config={},
                                work=dict(work_kw), host_s=[])
    return harness.load_module("metrics", name).read(ctx)


def test_metric_arithmetic():
    tr = trace.parse({"traceEvents": _events()})
    nodes = 4096 * 65 * 65
    assert _metric("launches_per_step.invert", tr, steps=4) == 0.5
    assert _metric("glue_device_ms_per_job.invert", tr) == pytest.approx(0.1)
    for name in ("idle_pct.invert", "idle_pct.forward",
                 "idle_pct.forward.host_paced"):
        assert _metric(name, tr) == pytest.approx(49.0)
    # K3a's 256 iterations: 20 operations a node and iteration at
    # 67 TFLOP/s (9 values a node at 3.35 TB/s is the shorter), over the
    # 400 µs of device time under the op
    least = 20.0 * nodes * 256 / 67e12
    assert least > 9 * 4 * nodes / 3.35e12
    for name in ("cg_roofline.invert", "cg_roofline.forward",
                 "cg_roofline.forward.host_paced"):
        assert _metric(name, tr) == pytest.approx(100 * least / 400e-6)
    # the window's share of the peak: one unit of that same work
    for name in ("mfu.forward", "mfu.forward.host_paced"):
        assert _metric(name, tr, dim=2, cg_node_iterations=nodes * 256,
                       steps=1) == pytest.approx(100 * least / 1e-3)


def test_op_call_work_refuses_what_it_cannot_count():
    assert work.op_call_work("difffe::stencil_cg", ["", "", "", "", "x"],
                             [[1], [1]]) is None
    assert work.op_call_work("aten::add", [], []) is None
    ops, nbytes = work.op_call_work(
        "difffe::stencil3d_cg2", ["", "", "", "", "", "", "", "100", ""],
        [[], [128, 33, 33, 33]])
    assert ops == 2 * 24 * 128 * 33 ** 3 * 100
    assert nbytes == 14 * 4 * 128 * 33 ** 3


def test_no_kernel_under_an_op_gives_no_roofline():
    events = [e for e in _events() if e["name"] != "difffe::stencil_cg"]
    tr = trace.parse({"traceEvents": events})
    assert _metric("cg_roofline.invert", tr) is None
    with pytest.raises(ValueError):
        trace.parse({"traceEvents": events[1:]})


@pytest.mark.parametrize("rename", [
    "difffe::stencil_cg_v2",                # an op the table does not hold
    None,                                   # its iterations moved
])
def test_an_op_whose_work_is_not_counted_gives_no_roofline(rename):
    events = _events()
    op = events[1]
    if rename:
        op["name"] = rename
    else:
        op["args"]["Concrete Inputs"] = ["", "", "", "", "", "256"]
    tr = trace.parse({"traceEvents": events})
    assert [k.op for k in tr.kernels] == [op["name"], None]
    assert _metric("cg_roofline.invert", tr) is None
    assert _metric("cg_roofline.forward", tr) is None


@pytest.mark.parametrize("name", ["host_ms_per_call.forward",
                                  "host_ms_per_call.forward.host_paced"])
def test_host_ms_median(name):
    ctx = types.SimpleNamespace(trace=None, host_s=[0.001, 0.003, 0.002])
    mod = harness.load_module("metrics", name)
    assert mod.read(ctx) == pytest.approx(2.0)
    assert mod.read(types.SimpleNamespace(trace=None, host_s=[])) is None
