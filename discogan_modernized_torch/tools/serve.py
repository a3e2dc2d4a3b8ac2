"""Model-serving daemon: an HTTP translation endpoint over a checkpoint,
on the card by default.

It loads the generators once, warms them (the first forward builds the
kernels and derives the weights' operand copies), and serves:

    POST /translate          image bytes (png/jpg) -> translated PNG
    POST /reconstruct        image bytes -> cycle-reconstructed PNG
    GET  /healthz            JSON liveness + model info
    GET  /stats              request count, p50/p99 latency

stdlib-only (ThreadingHTTPServer). The server runs each request on a new
thread, and the first CUDA work of a thread costs more than a forward, so
every device call runs on the Translator's one worker thread, which also
serializes them. ``Translator.translate`` / ``Translator.reconstruct`` are
the array-level calls, usable without PIL.

``--exported`` (and ``--exported_rev``) serves from ``torch.export``
artifacts instead (tools/export_model.py; ``ExportedTranslator``): no
checkpoint on the serving host, the generator and its precision fixed at
export. The daemon serves one image a request, so it takes an artifact of
static batch 1 or a symbolic batch and refuses a static larger batch.
``/healthz`` and ``/stats`` say whether it serves an artifact. Run:

    python -m discogan_modernized_torch.tools.serve \
        --model_path models/edges2shoes/discogan/<ts> --image_size 512
    python -m discogan_modernized_torch.tools.serve \
        --exported gen_B_final.pt2 [--exported_rev gen_A_final.pt2] --image_size 512
"""

from __future__ import annotations

import argparse
import io
import json
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.precision import configure, default_policy


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DiscoGAN 서빙 데몬 (PyTorch/CUDA)")
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint dir with gen_A_final.pth / gen_B_final.pth "
                        "(omit when serving --exported)")
    p.add_argument("--exported", type=str, default=None,
                   help="serve a torch.export artifact (.pt2, static batch 1 or "
                        "symbolic) instead of a checkpoint")
    p.add_argument("--exported_rev", type=str, default=None,
                   help="the reverse generator's artifact, for /reconstruct")
    p.add_argument("--direction", type=str, default="AtoB",
                   choices=["AtoB", "BtoA"])
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--dataset_type", type=str, default=None)
    p.add_argument("--domain", type=str, default=None, choices=["A", "B", None])
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--precision", type=str, default=None,
                   choices=["bf16", "f32"],
                   help="default bf16 on CUDA, f32 on the CPU")
    return p.parse_args(argv)


class Translator:
    """Loaded generators + the forward; thread-safe: the device work runs
    on one worker thread."""

    exported = False

    def __init__(self, model_path, direction, image_size, precision=None,
                 device="cuda"):
        from ..cli.inference import load_generators

        self.image_size = image_size
        self.device = resolve_device(str(device))
        self.policy = default_policy(precision, self.device)
        configure(self.policy)
        self.fwd, self.rev = load_generators(model_path, direction,
                                             image_size, self.device)
        self._start()

    def _start(self) -> None:
        self._worker = ThreadPoolExecutor(1, thread_name_prefix="translator")
        self.latencies: list = []
        self.count = 0
        # Warm, on the worker: build the kernels and derive the operand
        # copies before accepting traffic.
        self._worker.submit(self._warm).result()

    def _forward(self, gen, x):
        return gen(x, policy=self.policy)

    def _warm(self) -> None:
        dummy = torch.zeros(1, self.image_size, self.image_size, 3,
                            device=self.device)
        for gen in (self.fwd, self.rev):
            if gen is not None:
                self._forward(gen, dummy).cpu()

    def translate(self, img: np.ndarray, reconstruct: bool = False) -> np.ndarray:
        """(H,W,3) float image in [0,1] -> (H,W,3) float32 in [0,1]."""
        if reconstruct and self.rev is None:
            raise RuntimeError("reverse generator checkpoint not found")
        x = torch.as_tensor(np.asarray(img, np.float32))[None]
        return self._worker.submit(self._translate, x, reconstruct).result()

    def _translate(self, x: torch.Tensor, reconstruct: bool) -> np.ndarray:
        x = x.to(self.device)
        t0 = time.perf_counter()
        y = self._forward(self.fwd, x)
        if reconstruct:
            y = self._forward(self.rev, y)
        out = y[0].cpu().numpy()
        self.latencies.append(time.perf_counter() - t0)
        self.latencies = self.latencies[-1000:]
        self.count += 1
        return out

    def close(self) -> None:
        """Stop the worker thread."""
        self._worker.shutdown()

    def reconstruct(self, img: np.ndarray) -> np.ndarray:
        return self.translate(img, reconstruct=True)

    def stats(self) -> dict:
        lat = sorted(self.latencies)
        pct = lambda q: (lat[int(len(lat) * q)] * 1000) if lat else None  # noqa: E731
        return {"requests": self.count, "exported": self.exported,
                "p50_ms": pct(0.5), "p99_ms": pct(0.99)}


class ExportedTranslator(Translator):
    """``Translator`` over torch.export artifacts (tools/export_model.py):
    the weights and the precision are inside, so this host needs no
    checkpoint. Takes artifacts of static batch 1 or of a symbolic batch,
    each made into a module once."""

    exported = True

    def __init__(self, exported_path, image_size, exported_rev=None, device="cuda"):
        from ..cli.inference import load_artifact
        from .export_model import load_artifact_sidecar

        self.image_size = image_size
        self.device = resolve_device(str(device))
        baked = (load_artifact_sidecar(exported_path) or {}).get("precision")
        configure(default_policy(baked, self.device))
        modules = []
        for path in (exported_path, exported_rev):
            if path is None:
                modules.append(None)
                continue
            module, b = load_artifact(path, image_size, self.device)
            if b is not None and b != 1:
                raise ValueError(
                    f"artifact {path} was exported with static batch {b}; the daemon "
                    "serves one image a request: re-export with --batch 1 or --batch 0 "
                    "(symbolic)")
            modules.append(module)
        self.fwd, self.rev = modules
        self._start()

    @torch.no_grad()
    def _forward(self, module, x):
        return module(x)


def make_handler(translator, args):
    from PIL import Image, UnidentifiedImageError

    from ..data.preprocess import preprocess_array

    # An artifact's generator is fixed at export: report the sidecar's
    # direction, not the flag's.
    direction = args.direction
    if translator.exported:
        from .export_model import load_artifact_sidecar

        direction = (load_artifact_sidecar(args.exported) or {}).get(
            "direction", "fixed in the artifact")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "direction": direction,
                                 "image_size": args.image_size,
                                 "device": str(translator.device),
                                 "exported": translator.exported})
            elif self.path == "/stats":
                self._json(200, translator.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path not in ("/translate", "/reconstruct"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                with Image.open(io.BytesIO(raw)) as im:
                    img = np.array(im.convert("RGB"))
            except (UnidentifiedImageError, OSError, ValueError) as e:
                self._json(400, {"error": str(e)})
                return
            dom = (args.domain if args.dataset_type in
                   ("edges2handbags", "edges2shoes") else None)
            x = preprocess_array(img, dom, args.image_size)
            try:
                y = translator.translate(
                    x, reconstruct=self.path == "/reconstruct")
            except RuntimeError as e:
                self._json(400, {"error": str(e)})
                return
            out = Image.fromarray((np.clip(y, 0, 1) * 255).astype(np.uint8))
            buf = io.BytesIO()
            out.save(buf, format="PNG")
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def serve(args):
    """Load and warm the Translator, bind the server (not yet serving)."""
    if args.exported:
        translator = ExportedTranslator(args.exported, args.image_size,
                                        args.exported_rev, args.device)
    elif args.model_path:
        translator = Translator(args.model_path, args.direction, args.image_size,
                                args.precision, args.device)
    else:
        raise SystemExit("one of --model_path or --exported is required")
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(translator, args))
    print(f"서빙 시작: http://{args.host}:{server.server_address[1]} "
          f"({args.direction}, {args.image_size}px, {translator.device})")
    return server, translator


def main(argv=None):
    args = parse_args(argv)
    server, translator = serve(args)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        translator.close()


if __name__ == "__main__":
    main()
