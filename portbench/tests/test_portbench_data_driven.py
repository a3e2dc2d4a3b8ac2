"""A cell, a configuration, a traffic mix, a per-layer metric and a kernel
class added as new files and new BENCHMARK.json entries, in a copy of the
benchmark, run with no file of the harness edited."""

from __future__ import annotations

import json
import shutil

import torch

from tiny import ROOT

from portbench import harness, tracing


def _copy(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_a_cell_added_as_files_runs(tmp_path):
    root = _copy(tmp_path)
    here = root / "portbench"
    config = json.loads((here / "configs" / "discogan64.json").read_text())
    config.update(name="discogan16", image_size=16, n_halvings=2, channels=[64, 128])
    config["train"]["precision"] = "f32"
    (here / "configs" / "discogan16.json").write_text(json.dumps(config))
    traffic = {"driver": "train_chunked", "batch": 4, "dataset": {"images_per_domain": 16},
               "trace_chunks": 1, "why": "a tiny mix"}
    (here / "traffic" / "chunked_b4_tiny.json").write_text(json.dumps(traffic))
    cell = {"config": "discogan16", "traffic": "chunked_b4_tiny", "why": "a tiny cell",
            "kernels": ["conv_k4s2p1"], "control": "fp8",
            "limits": {"loss_gap": 0.01, "grad_gap": 0.05, "change_gap": 0.2,
                       "dgrad_median_gap": 0.01}}
    (here / "workloads" / "train16.b4.json").write_text(json.dumps(cell))
    (here / "metrics" / "iterations_traced.py").write_text(
        "def read(s):\n    return s['iterations'] or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "discogan16", "source": "a test", "reduced": [],
                             "file": "portbench/configs/discogan16.json", "why": "a test"})
    bench["workloads"].append({"name": "train16.b4", "config": "discogan16",
                               "traffic": "chunked_b4_tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "iterations_traced", "unit": "iter",
                               "better": "higher", "source": "program_counter",
                               "layer": "train step", "moves": "train_img_per_s",
                               "workloads": ["train16.b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = harness.cell_spec("train16.b4", root)
    assert "iterations_traced" in [m["name"] for m in spec["per_layer"]]
    out = harness.driver(spec).run(spec, 2 ** 31 + 17, 0.0, False, torch.device("cpu"), 0.0)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_img_per_s", "setup_s"}
    traced = harness.driver(spec).run(spec, 5, 0.0, True, torch.device("cpu"), 0.0)
    # on the CPU the device metrics read nothing; the new reader reads its count
    assert traced["metrics"] == {"iterations_traced": {"value": 24.0, "unit": "iter"}}


def test_a_kernel_class_added_as_a_directory(tmp_path):
    here = _copy(tmp_path) / "portbench"
    (here / "classes" / "fused_adam").mkdir()
    (here / "classes" / "fused_adam" / "kernels.txt").write_text("# a later kernel\n"
                                                                 r"\bfused_adam_kernel\b" "\n")
    classes = harness.kernel_classes(here)
    assert harness.classify("void fused_adam_kernel<float>(x)", classes) == ["fused_adam"]


class _Event:
    def __init__(self, name, device, start, end):
        self._n, self._d, self._s, self._e = name, device, start, end

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s


def test_trace_summary_busy_idle_and_classes():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Event("portbench.chunk", cpu, 0, 1000), _Event("portbench.replay", cpu, 100, 900),
              _Event("portbench.sync", cpu, 1000, 1200),
              _Event("void batch_stats_kernel<float>(x)", cuda, 100, 400),
              _Event("void at::native::reduce_kernel<4>(x)", cuda, 300, 600),
              _Event("Memcpy HtoD (Pinned -> Device)", cuda, 700, 800),
              _Event("portbench.chunk", cuda, 0, 1000)]
    s = tracing.summarize(events, harness.kernel_classes())
    assert s["window_s"] == 1200e-9 and s["busy_s"] == 600e-9 and s["kernel_count"] == 2
    assert s["classes"] == {"port_bn": 300e-9, "elementwise": 300e-9, "copy": 100e-9}
    # each gap named by the span the host was in when the device went idle
    assert s["breakdown"]["idle_gaps"] == [["replay", 400e-9], ["replay", 100e-9],
                                           ["chunk", 100e-9]]
