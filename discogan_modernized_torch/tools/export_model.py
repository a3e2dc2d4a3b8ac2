"""Serving artifacts: the eval-mode generator forward as a ``torch.export``
program, saved as ``.pt2`` (the port of the JAX package's
``tools/export_model.py``).

``export_generator`` wraps the eval forward with its precision fixed
(``ServingGenerator``: the weights in the forms the kernels take, HWIO in
the compute dtype and the BatchNorm folded into f32 scale and offset, as
buffers) and runs ``torch.export.export`` on it. The kernels of the eval
forward are registered ops (ops/library.py), so the program records
``discogan::conv2d_k4s2p1``, ``halo_conv2d_k4s2p1``, ``fused_batchnorm_act``
and ``head_convt_fwd`` nodes whichever device traced it, and each op
carries both implementations: on a CUDA tensor it launches its kernel, on
a CPU tensor it runs the plain version. The weights travel inside the
artifact, stored on the CPU; ``load_exported`` registers the ops, loads the
program and moves it to the serving device. The serving host needs the
port's ops (the kernels' sources) but no checkpoint.

``--batch 0`` exports a symbolic batch (``Dim("b")``): one artifact serves
any batch. Otherwise the batch is static. ``--platforms cuda,cpu`` names
the devices the artifact may serve on (default: the exporting device);
the exporter writes them into the sidecar (``<artifact>.json``, the JAX
sidecar's keys) and the loader refuses a device that is not listed.

    python -m discogan_modernized_torch.tools.export_model \\
        --model_path models/<task>/<arch>/<ts> --direction AtoB \\
        --image_size 512 [--batch 1] [--platforms cuda,cpu] [--output gen.pt2]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from ..core.device import resolve_device
from ..core.precision import Policy, default_policy
from ..models.generator import Generator, eval_forward
from ..ops.library import SERVING_OPS

PLATFORMS = ("cuda", "cpu")


class ServingGenerator(nn.Module):
    """A generator's eval operands at one compute dtype as buffers, and
    its eval forward through the registered ops: the module that
    ``export_generator`` exports. The decoder's wide convT weights are kept
    in their contiguous (I, 4, 4, O) order and viewed channels-last in the
    forward, as the eval forward takes them."""

    def __init__(self, gen: Generator, policy: Policy):
        super().__init__()
        self.compute_dtype = policy.compute_dtype
        p = gen._operands(self.compute_dtype)
        self.n_enc, self.n_dec = len(p["enc"]), len(p["dec"])
        for i, (w, scale, offset) in enumerate(p["enc"]):
            self._keep(f"enc{i}", w, scale, offset)
        self._keep("latent", *p["latent"])
        for j, (w, scale, offset) in enumerate(p["dec"]):
            self._keep(f"dec{j}", w if j == 0 else w.movedim(-3, -1), scale, offset)
        self._keep("head", p["head"])

    def _keep(self, name: str, w, scale=None, offset=None) -> None:
        for part, t in (("w", w), ("scale", scale), ("offset", offset)):
            if t is not None:
                self.register_buffer(f"{name}_{part}", t.detach().clone(
                    memory_format=torch.contiguous_format))

    def _layer(self, name: str, w=None):
        return (getattr(self, f"{name}_w") if w is None else w,
                getattr(self, f"{name}_scale", None), getattr(self, f"{name}_offset", None))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = {"enc": [self._layer(f"enc{i}") for i in range(self.n_enc)],
             "latent": self._layer("latent"),
             "dec": [self._layer(f"dec{j}", None if j == 0 else
                                 getattr(self, f"dec{j}_w").movedim(-1, -3))
                     for j in range(self.n_dec)],
             "head": self.head_w}
        return eval_forward(p, x, self.compute_dtype, SERVING_OPS)


def export_generator(gen: Generator, image_size: int, *, batch: int = 1,
                     platforms=None, precision: str | None = None):
    """The eval-mode forward of ``gen`` with its weights inside, as a
    ``torch.export.ExportedProgram`` whose weights are on the CPU. batch=0
    exports a symbolic batch dimension ("b"); otherwise the program takes
    that static batch. The compute dtype is ``precision``'s, else the
    device's default (bf16 on the card, f32 on the CPU). ``platforms`` is
    checked here and recorded by the caller (the sidecar)."""
    if batch < 0:
        raise ValueError(f"batch must be >= 0, got {batch}")
    check_platforms(platforms)
    device = gen.encoder[0].weight.device
    policy = default_policy(precision, device)
    module = ServingGenerator(gen.eval(), policy).eval()
    example = torch.zeros(batch or 2, image_size, image_size, 3, device=device)
    dynamic = ({0: torch.export.Dim("b", min=1)},) if batch == 0 else None
    program = torch.export.export(module, (example,), dynamic_shapes=dynamic)
    if device.type != "cpu":
        program = move_to_device_pass(program, "cpu")
    return program


def check_platforms(platforms) -> list:
    platforms = list(platforms or [])
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"platforms {unknown}: the port serves on {list(PLATFORMS)}")
    return platforms


def export_from_checkpoint(model_path, direction: str, image_size: int, *,
                           batch: int = 1, platforms=None, precision: str | None = None,
                           device="cuda"):
    """(program, generator name) for a reference-layout checkpoint dir:
    AtoB serves gen_B, BtoA serves gen_A (the inference CLI's mapping, ref
    inference.py:127-132). The generator is traced on ``device`` (the card
    unless the caller asks for the CPU)."""
    from ..train.checkpoint import load_reference_weights

    device = resolve_device(str(device))
    name = "gen_B" if direction == "AtoB" else "gen_A"
    gen = load_reference_weights(Path(model_path) / f"{name}_final.pth", image_size,
                                 device)
    return export_generator(gen, image_size, batch=batch, platforms=platforms,
                            precision=precision), name


def load_artifact_sidecar(path) -> dict | None:
    """The exporter's sidecar (<artifact>.json), or None when absent or
    unreadable."""
    p = Path(path)
    try:
        return json.loads(p.with_suffix(p.suffix + ".json").read_text())
    except (OSError, ValueError):
        return None


def load_exported(path, device="cuda"):
    """The artifact's program on ``device`` (the ops registered first; the
    card unless the caller asks for the CPU). Refuses a device that the
    sidecar's platforms do not list. Call it through ``program.module()``,
    made once: the counterpart of JAX's ``jax.jit(exp.call)``."""
    device = resolve_device(str(device))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    meta = load_artifact_sidecar(path)
    if meta is not None and device.type not in meta.get("platforms", PLATFORMS):
        raise ValueError(f"artifact {path} was exported for {meta['platforms']}, "
                         f"not {device.type}: re-export with --platforms "
                         f"{','.join([*meta['platforms'], device.type])}")
    program = torch.export.load(str(path))
    if device.type != "cpu":
        program = move_to_device_pass(program, device)
    return program


def artifact_input_shape(program) -> tuple:
    """(batch or None, H, W, C) of the artifact's image input."""
    spec = next(s for s in program.graph_signature.input_specs
                if s.kind == torch.export.graph_signature.InputKind.USER_INPUT)
    node = next(n for n in program.graph.nodes if n.name == spec.arg.name)
    shape = node.meta["val"].shape
    b = shape[0]
    return (int(b) if isinstance(b, int) else None, *map(int, shape[1:]))


def discogan_nodes(program) -> dict:
    """op name -> its ``discogan::`` nodes in the program's graph."""
    out: dict = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("discogan."):
            op = name.split(".")[1]
            out[op] = out.get(op, 0) + 1
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model_path", type=str, required=True,
                    help="checkpoint dir holding gen_{A,B}_final.pth")
    ap.add_argument("--direction", type=str, default="AtoB", choices=["AtoB", "BtoA"])
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1,
                    help="static serving batch; 0 = symbolic (any batch)")
    ap.add_argument("--platforms", type=str, default=None,
                    help="comma list of the devices it may serve on (cuda, cpu); "
                         "default: the exporting device")
    ap.add_argument("--precision", type=str, default=None, choices=[None, "bf16", "f32"],
                    help="compute dtype baked into the artifact (default: bf16 on "
                         "CUDA, f32 on the CPU)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device that traces the generator (cuda raises without "
                         "a card; cpu)")
    ap.add_argument("--output", type=str, default=None,
                    help="artifact path (default: <model_path>/<gen>_final.pt2)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.batch < 0:
        raise SystemExit(f"--batch must be >= 0, got {args.batch}")
    device = resolve_device(args.device)
    platforms = ([p.strip() for p in args.platforms.split(",") if p.strip()]
                 if args.platforms else [device.type])
    try:
        check_platforms(platforms)
    except ValueError as e:
        raise SystemExit(str(e))
    t0 = time.perf_counter()
    try:
        program, name = export_from_checkpoint(
            args.model_path, args.direction, args.image_size, batch=args.batch,
            platforms=platforms, precision=args.precision, device=device)
    except FileNotFoundError as e:
        print(f"모델 로드 실패: {e}")
        return 1
    out = Path(args.output) if args.output else (
        Path(args.model_path) / f"{name}_final.pt2")
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(out))
    seconds = time.perf_counter() - t0
    meta = {
        "generator": name,
        "direction": args.direction,
        "image_size": args.image_size,
        "batch": "symbolic" if args.batch == 0 else args.batch,
        "platforms": platforms,
        "precision": default_policy(args.precision, device).name,
        "source_checkpoint": str(Path(args.model_path).resolve()),
        "artifact_bytes": out.stat().st_size,
        "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    out.with_suffix(out.suffix + ".json").write_text(json.dumps(meta, indent=2) + "\n")
    batch_s = "b (symbolic)" if args.batch == 0 else str(args.batch)
    print(f"exported {name} -> {out} ({meta['artifact_bytes'] / 1e6:.2f} MB, "
          f"batch={batch_s}, platforms={','.join(platforms)}, {meta['precision']}, "
          f"{seconds:.2f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
