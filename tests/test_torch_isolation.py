"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the CPU when asked for CUDA."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "discogan_modernized_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|discogan_modernized_tpu)\b", re.M)


def port_modules():
    return sorted(
        "discogan_modernized_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import importlib\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.startswith('discogan_modernized_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


# The modules the train step's graph variants added: the checks above and
# below take every module of the port, these with them.
VARIANT_MODULES = ["discogan_modernized_torch.tools.remat_bench",
                   "discogan_modernized_torch.models.regions",
                   "discogan_modernized_torch.ops.pairs",
                   "discogan_modernized_torch.ops.recompute"]


# And those of the multi-step driver.
MULTISTEP_MODULES = ["discogan_modernized_torch.train.chunk",
                     "discogan_modernized_torch.train.profiling"]


# And those of the (data, model) mesh.
MESH_MODULES = ["discogan_modernized_torch.core.mesh",
                "discogan_modernized_torch.ops.sharding",
                "discogan_modernized_torch.parallel.gspmd"]


@pytest.mark.parametrize("module", VARIANT_MODULES + MULTISTEP_MODULES + MESH_MODULES)
def test_variant_modules_are_checked(module):
    assert module in port_modules()
    path = PKG / Path(*module.split(".")[1:]).with_suffix(".py")
    assert not FORBIDDEN.search(path.read_text())


def test_sources_import_no_jax():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert not offenders


def test_native_library_and_caches_are_the_ports_own(monkeypatch):
    """The port builds its own copy of the native source, and keeps its
    native build and its decoded-sample cache under this checkout's build/,
    apart from the JAX package's directories under ~/.cache; no source of
    the port names a path into the JAX package or the home directory."""
    from discogan_modernized_torch.data import cache, native

    monkeypatch.delenv("DISCOGAN_TORCH_CACHE_DIR", raising=False)
    assert native._SRC == PKG / "native" / "discodata.cpp"
    assert native.BUILD_DIR == ROOT / "build" / "native"
    assert cache.cache_root() == ROOT / "build" / "data_cache"
    sources = list(PKG.rglob("*.py")) + list(PKG.rglob("*.cpp"))
    pattern = re.compile(r"discogan_modernized_tpu|[\"'/]\.cache\b|Path\.home|expanduser")
    assert not [str(f) for f in sources if pattern.search(f.read_text())]


@pytest.mark.parametrize("entry", ["inference", "serve", "trainer", "device",
                                   "angle", "real_data"])
def test_cuda_request_raises_without_a_card(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "inference":
            from discogan_modernized_torch.cli.inference import main

            main([f"--model_path={tmp_path}", f"--input_path={tmp_path}"])
        elif entry in ("trainer", "real_data"):
            from discogan_modernized_torch.cli.image_translation import main

            task = "synthetic" if entry == "trainer" else "edges2shoes"
            main([f"--task_name={task}", f"--models_dir={tmp_path}",
                  f"--results_dir={tmp_path}"])
        elif entry == "angle":
            from discogan_modernized_torch.cli.angle_pairing import main

            main([f"--models_dir={tmp_path}", f"--results_dir={tmp_path}"])
        elif entry == "serve":
            from discogan_modernized_torch.tools.serve import parse_args, serve

            serve(parse_args([f"--model_path={tmp_path}", "--port=0"]))
        else:
            from discogan_modernized_torch.core.device import resolve_device

            resolve_device("cuda")


def test_defaults_are_cuda_and_bf16_there():
    from discogan_modernized_torch.cli.common import (inference_parser,
                                                     translation_parser)
    from discogan_modernized_torch.core.precision import BF16, F32, default_policy
    from discogan_modernized_torch.tools.serve import parse_args

    args = inference_parser().parse_args(["--model_path=m", "--input_path=i"])
    assert args.device == "cuda"
    assert parse_args(["--model_path=m"]).device == "cuda"
    train_args = translation_parser().parse_args([])
    assert (train_args.device, train_args.slim_state) == ("cuda", "mv")
    from discogan_modernized_torch.cli.common import angle_parser
    assert angle_parser().parse_args([]).device == "cuda"
    assert default_policy(None, "cuda") is BF16
    assert default_policy(None, "cpu") is F32
    with pytest.raises(ValueError):
        default_policy("fp32")
