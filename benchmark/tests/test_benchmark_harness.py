"""The harness on the CPU at tiny sizes: finding everything by name, the
result line, the import check, and ``correct`` coming out false for the
control and for every fault a cell can have."""

import json
import math
import re
import shutil

import pytest
import torch

from benchmark import faults, harness, programs
from benchmark.tests import tinycells

SPEC = tinycells.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinycells.tiny_root(tmp_path_factory.mktemp("tiny"))


def test_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1] == "benchmark/run.py"
    cells = 24     # the full check the run length must fit
    assert (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    reported = {}
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        for w in m.get("workloads", CELLS):
            reported.setdefault(w, set()).add(m["name"])
    assert all("setup_s" in reported[w] and len(reported[w]) >= 2
               for w in CELLS)
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"])
        assert all(m["moves"] in reported[w] for w in m["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [c["source"] for c in SPEC["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    found = harness.find_cell(SPEC, name)
    assert found["config"]["name"] == found["cell"]["config"]
    assert callable(found["kind"].window)
    assert set(found["kind"].END_TO_END) | {"setup_s"} == {
        m["name"].split(".", 1)[0]
        for m in harness.end_to_end_for(SPEC, name)}
    config = next(c for c in SPEC["configs"]
                  if c["name"] == found["cell"]["config"])
    assert json.load(open(harness.CHECKOUT / config["file"])) == \
        found["config"]
    assert config["reduced"] == found["config"]["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_is_found_as_a_module_by_its_name(metric):
    mod = harness.load_module("metrics", metric)
    assert callable(mod.read)
    assert mod.__doc__


def test_import_check_takes_whole_top_level_names():
    ok = ["torch", "difffe_tpu_torch", "difffe_tpu_torch.ops.stencil",
          "jaxtyping", "flaxen"]
    bad = ["difffe_tpu", "difffe_tpu.ops.pallas", "jax", "jax._src.api",
           "jaxlib.xla_client", "flax.linen"]
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok + bad) == sorted(bad)


@pytest.mark.parametrize("name", CELLS)
def test_result_line_of_a_sound_run(root, name):
    line = tinycells.run(root, name)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {
        m["name"] for m in harness.end_to_end_for(SPEC, name)}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


@pytest.mark.parametrize("name,host", [
    ("kappa2d_64.forward", "host_ms_per_call.forward"),
    ("kappa3d_32.forward", "host_ms_per_call.forward.host_paced")])
def test_traced_run_reads_per_layer_metrics(root, name, host):
    line = tinycells.run(root, name, trace=True, seconds=0.5)
    # the CPU trace holds no kernel: the device readers return nothing,
    # the host's span is still read
    assert set(line["metrics"]) == {host}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"


def test_new_cell_and_metric_are_found_as_new_files(root, tmp_path):
    new = tmp_path / "benchmark"
    shutil.copytree(root, new)
    cell = json.loads((new / "workloads" / "kappa3d_32.forward.json")
                      .read_text())
    cell["traffic"] = "forward_b8"
    cell["batch"] = 8
    (new / "workloads" / "kappa3d_32.forward_b8.json").write_text(
        json.dumps(cell))
    (new / "metrics" / "calls_traced.forward_b8.py").write_text(
        '"""Traced calls."""\n\n\ndef read(ctx):\n'
        "    return float(ctx.trace.units)\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "kappa3d_32.forward_b8",
                              "config": "kappa3d_32",
                              "traffic": "forward_b8", "chips": 1,
                              "why": "a test cell"})
    # its own bound on the forward kind's rate, by a qualified name
    spec["end_to_end"].append({"name": "solves_per_s.b8",
                               "unit": "solves/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["kappa3d_32.forward_b8"]})
    spec["per_layer"].append({"name": "calls_traced.forward_b8",
                              "unit": "calls", "better": "higher",
                              "source": "device_trace", "layer": "entry",
                              "moves": "solves_per_s.b8"})
    line = harness.run("kappa3d_32.forward_b8", 3, 0.5, False,
                       device="cpu", spec=spec, root=new,
                       log=lambda *a: None)
    assert set(line["metrics"]) == {"solves_per_s.b8", "setup_s"}
    assert line["metrics"]["solves_per_s.b8"]["value"] > 0
    line = harness.run("kappa3d_32.forward_b8", 3, 0.5, True, device="cpu",
                       spec=spec, root=new, log=lambda *a: None)
    assert line["metrics"] == {"calls_traced.forward_b8": {"value": 1.0,
                                                           "unit": "calls"}}
    assert line["correct"] is True


def _limits_failed(line):
    return [k for k, c in line["checks"].items()
            if math.isnan(c["value"]) or c["value"] > c["limit"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_in_lower_precision_is_not_correct(root, name):
    found = harness.find_cell(SPEC, name, root)
    control = programs.Reference(found["config"], found["cell"],
                                 torch.bfloat16)
    line = tinycells.run(root, name, program=control)
    assert line["correct"] is False and _limits_failed(line)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_every_fault_is_not_correct(root, monkeypatch, name, fault):
    faults.FAULTS[fault](monkeypatch)
    line = tinycells.run(root, name)
    assert line["correct"] is False and _limits_failed(line)


def test_control_script_plants_each_fault_and_undoes_it(root):
    import types

    from benchmark import control
    from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as sk

    before = sk._cg
    args = types.SimpleNamespace(
        workload="kappa2d_64.forward", seeds=[7], control_seeds=[],
        faults=["altered"], fault_seeds=[7], seconds=0.0)
    got = [(who, line["correct"]) for who, _, line in control.readings(
        args, device="cpu", spec=SPEC, root=root)]
    assert got == [("program", True), ("fault:altered", False)]
    assert sk._cg is before


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the refusal "
                    "without one")
    from benchmark import run

    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
