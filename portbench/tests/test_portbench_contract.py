"""BENCHMARK.json against the benchmark's contract: keys, names, units,
limits, and every piece found by name."""

from __future__ import annotations

import json
import re

import pytest

from tiny import ROOT

from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert not any(p.startswith("/") or ".." in p or p.endswith("_torch")
                   for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    for word in BENCH["command"]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_units(section):
    entries = BENCH[section]
    assert entries
    assert len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        assert set(e) <= KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert _line(e[key]), (e["name"], key)


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


def test_configs_files_and_reduced():
    cells = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in cells
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_workloads_chips_and_pairs():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_found_by_name(cell):
    spec = harness.cell_spec(cell, ROOT)
    assert spec["cell"]["config"] == spec["entry"]["config"]
    assert spec["cell"]["traffic"] == spec["entry"]["traffic"]
    assert hasattr(harness.driver(spec), "run")
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert callable(harness.reader(m["name"]))
    assert spec["cell"]["limits"] and spec["cell"]["kernels"]
    assert spec["cell"]["control"] == "fp8"


def test_run_seconds_fits_the_check():
    n = 24  # the most cells a later PR may have
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert 1 <= BENCH["run_seconds"] <= 51 and total <= 43200


def test_kernel_classes_found_and_disjoint():
    classes = harness.kernel_classes()
    assert {"port_conv", "port_bn", "library", "elementwise", "copy"} <= set(classes)
    samples = {
        "void (anonymous namespace)::wg::conv_wgmma_kernel<128, 256, 4>(x)": "port_conv",
        "void (anonymous namespace)::halo_dw_fma_kernel<64>(x)": "port_conv",
        "void splitk_epilogue_kernel(float const*)": "port_conv",
        "void (anonymous namespace)::batch_stats_kernel<float>(x)": "port_bn",
        "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": "library",
        "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN": "library",
        "void cudnn::engines_precompiled::nchwToNhwcKernel<float>(x)": "library",
        "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>":
            "elementwise",
        "Memcpy HtoD (Pinned -> Device)": "copy",
    }
    for name, cls in samples.items():
        assert harness.classify(name, classes) == [cls], name
