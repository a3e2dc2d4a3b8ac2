"""The run's guards and its last line: no card, no result; a forbidden
module, no result; the result line's keys, ``checks`` last."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest

from tiny import ROOT, run_tiny, tiny_spec

from portbench import harness


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "train64.b64",
                        "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                            "HOME": str(ROOT / "build"), "OMP_NUM_THREADS": "1"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_directory_without_the_port_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); import torch; from portbench import harness;"
            "s = harness.cell_spec('train64.b64');"
            "harness.driver(s).run(s, 1, 0.0, False, torch.device('cpu'), 0.0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                    "OMP_NUM_THREADS": "1"})
    assert p.returncode != 0 and "discogan_modernized_torch" in p.stderr
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "discogan_modernized_tpu"])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name + ".sub", types.ModuleType(name + ".sub"))
    assert harness.forbidden_modules() == [name]


def test_a_name_that_only_begins_like_one_is_not_forbidden(monkeypatch):
    for name in ("jaxtyping", "discogan_modernized_tpu_extra", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []


def test_the_port_and_harness_load_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, '.'); import torch; from portbench import harness;"
            "s = harness.cell_spec('train64.b64');"
            "import portbench.reference.discogan, portbench.control, portbench.tracing;"
            "d = harness.driver(s); import discogan_modernized_torch.train.chunk;"
            "print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "discogan_modernized" not in text.replace("discogan_modernized_torch'", ""), path
        assert "import jax" not in text and "from jax" not in text, path


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line(capsys, trace):
    out = run_tiny(tiny_spec(), trace=trace)
    harness.emit(out)
    captured = capsys.readouterr()
    line = captured.out.strip().splitlines()[-1]
    result = json.loads(line)
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for k, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
        assert f"check {k}:" in captured.err
    assert captured.err.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["metrics"] == {}  # a CPU run writes no device metric
    else:
        assert set(result["metrics"]) == {"train_img_per_s", "setup_s"}
