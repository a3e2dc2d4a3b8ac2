"""What every cell shares: finding its pieces by name, the kernel classes,
the metric readers, the guards and the result line.

A cell is found through ``BENCHMARK.json``: its workload entry names a
configuration (whose ``file`` holds the model's sizes and the step's
settings) and a traffic mix (``traffic/<traffic>.json``, whose ``driver``
names a module ``drivers/<driver>.py``); ``workloads/<cell>.json`` holds
the cell's own settings: the kernels its path must launch and the limits
of the numbers that decide ``correct``. A per-layer metric is a module
``metrics/<name>.py`` whose ``read(summary)`` returns a number or None; a
kernel class is a directory ``classes/<class>/`` of pattern files. So a new
cell, configuration, traffic mix, metric or class is new files and new
entries, and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "discogan_modernized_tpu")


def repo_root(here: Path = HERE) -> Path:
    return here.parent


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, root: Path | None = None) -> dict:
    """Everything a run of cell ``name`` needs, found by name from the
    BENCHMARK.json at ``root`` (the checkout)."""
    root = root or repo_root()
    bench = load_json(root / "BENCHMARK.json")
    here = root / "portbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[entry["config"]]
    traffic = load_json(here / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"name": name, "root": root, "here": here, "entry": entry,
            "config": load_json(root / config_entry["file"]), "traffic": traffic,
            "cell": load_json(here / "workloads" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def driver(spec: dict):
    return load_module(spec["here"] / "drivers" / f"{spec['traffic']['driver']}.py",
                       f"portbench_driver_{spec['traffic']['driver']}")


def kernel_classes(here: Path = HERE) -> dict:
    """class -> compiled patterns, from ``classes/<class>/*.txt``."""
    out = {}
    for d in sorted(p for p in (here / "classes").iterdir() if p.is_dir()):
        pats = []
        for f in sorted(d.glob("*.txt")):
            pats += [re.compile(line.strip()) for line in f.read_text().splitlines()
                     if line.strip() and not line.lstrip().startswith("#")]
        out[d.name] = pats
    return out


def classify(name: str, classes: dict) -> list:
    return [c for c, pats in classes.items() if any(p.search(name) for p in pats)]


def reader(name: str, here: Path = HERE):
    """The ``read`` of per-layer metric ``name`` (``metrics/<name>.py``)."""
    return load_module(here / "metrics" / f"{name}.py",
                       "portbench_metric_" + re.sub(r"\W", "_", name)).read


def read_metrics(entries: list, summary: dict, here: Path = HERE) -> dict:
    """name -> {"value", "unit"} of each per-layer metric whose reader finds
    something to read."""
    out = {}
    for m in entries:
        value = reader(m["name"], here)(summary)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole."""
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): each number compared beside its limit; a number
    that is missing or not finite fails."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
              for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def emit(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output, ``checks`` its last key."""
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def process_start_time() -> float | None:
    """The process's start on the epoch clock, from /proc (10 ms ticks)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        btime = next(int(line.split()[1]) for line in
                     Path("/proc/stat").read_text().splitlines() if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return None
