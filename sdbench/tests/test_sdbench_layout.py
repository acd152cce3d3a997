"""BENCHMARK.json against the files it names and the contract's shape; a
metric or traffic file added by name is found with no edit to the code; the
result line's keys; and what the harness's modules import."""

import ast
import json
import os
import re
import shutil
import sys

import pytest

import harness
import run as bench_run

SDBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(SDBENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PORT = "stable_diffusion_pytorch_tpu_torch"
JAX_SIDE = {"jax", "jaxlib", "flax", "stable_diffusion_pytorch_tpu"}


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_entry_resolves_to_its_files():
    spec = _spec()
    assert spec["command"][:2] == ["python3", "sdbench/run.py"] and spec["paths"] == ["sdbench"]
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("sdbench/configs/")
        assert harness.load_json("configs", c["name"])["source"] == c["source"]
    for w in spec["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        traffic = harness.load_json("traffic", w["traffic"])
        assert os.path.isfile(os.path.join(SDBENCH, "drivers", f"{traffic['driver']}.py"))
        limits = harness.load_json("limits", w["name"])
        assert limits and all(v >= 0 for v in limits.values())
    for m in spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        for cell in m["workloads"]:
            e2e = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
            assert "workloads" not in e2e or cell in e2e["workloads"]


def test_entries_keep_the_contracts_shape():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["why"]) <= 200
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"} and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert next(m for m in spec["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"} and UNIT.match(m["unit"])
    cells = [w["name"] for w in spec["workloads"]]
    for cell in cells:
        e2e = bench_run._entries(spec, "end_to_end", cell)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert bench_run._entries(spec, "per_layer", cell)


def test_a_metric_and_a_traffic_file_added_by_name_are_found(tmp_path, monkeypatch):
    copy = tmp_path / "sdbench"
    shutil.copytree(SDBENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "metrics" / "kernel_count.sample.py").write_text(
        "def read(rec):\n    return float(len(rec.get('kernels', [])))\n")
    (copy / "traffic" / "txt2img-512-b8.json").write_text(json.dumps({"driver": "txt2img", "batch": 8}))
    monkeypatch.setattr(harness, "HERE", str(copy))
    spec = _spec()
    cell = spec["workloads"][0]["name"]
    spec["per_layer"].append({"name": "kernel_count.sample", "unit": "kernels", "better": "lower",
                              "source": "device_trace", "layer": "device", "moves": "setup_s",
                              "workloads": [cell]})
    record = {"kernels": [("gn_fwd_cluster_kernel", 0.0, 1e-3), ("k", 2e-3, 3e-3)], "window_s": 4e-3}
    assert bench_run.per_layer_metrics(spec, cell, record)["kernel_count.sample"]["value"] == 2.0
    assert harness.load_json("traffic", "txt2img-512-b8")["batch"] == 8


def test_result_line_keys_and_the_compared_numbers_last():
    outcome = harness.Outcome(end_to_end={}, record={}, checks=[("unet", 0.01), ("decode_rms", 0.2)], attempted=9,
                              failed=0, memory_peak_bytes=123, busy_s=1.5, window_s=2.0,
                              breakdown={"device_ops": [["conv", 1.0]], "idle_gaps": [["fetch", 0.1]]})
    line = bench_run.result_line(outcome, {"images_per_s": {"value": 2.0, "unit": "images/s"}},
                                 {"unet": 0.05, "decode_rms": 0.3}, 1, "NVIDIA H100 80GB HBM3", trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "compared"]
    assert line["correct"] is True
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"}
    over = bench_run.result_line(outcome, {}, {"unet": 0.005, "decode_rms": 0.3}, 1, "x", trace=False)
    assert over["correct"] is False and "busy_s" not in over["device"]
    missing = bench_run.result_line(outcome, {}, {"unet": 0.05, "decode_rms": 0.3, "start": 1.0}, 1, "x", False)
    assert missing["correct"] is False


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = _spec()["workloads"][0]["name"]
    assert bench_run.main(["--workload", cell, "--seed", str(2 ** 40), "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(SDBENCH, sub)):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_module_of_the_harness_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not JAX_SIDE & set(_imports(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert PORT not in set(_imports(path)), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + ".fake", object())
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "stable_diffusion_pytorch_tpu.fake", object())
    assert bench_run.forbidden_modules() == ["stable_diffusion_pytorch_tpu"]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import subprocess

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    cell = _spec()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "sdbench/run.py", "--workload", cell, "--seed", str(2 ** 33 + 5),
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
