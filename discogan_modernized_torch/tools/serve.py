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
the array-level calls, usable without PIL. The JAX daemon's ``--exported`` artifact mode
is not ported yet. Run:

    python -m discogan_modernized_torch.tools.serve \
        --model_path models/edges2shoes/discogan/<ts> --image_size 512
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
    p.add_argument("--model_path", type=str, required=True,
                   help="checkpoint dir with gen_A_final.pth / gen_B_final.pth")
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

    def __init__(self, model_path, direction, image_size, precision=None,
                 device="cuda"):
        from ..cli.inference import load_generators

        self.image_size = image_size
        self.device = resolve_device(str(device))
        self.policy = default_policy(precision, self.device)
        configure(self.policy)
        self.fwd, self.rev = load_generators(model_path, direction,
                                             image_size, self.device)
        self._worker = ThreadPoolExecutor(1, thread_name_prefix="translator")
        self.latencies: list = []
        self.count = 0
        # Warm, on the worker: build the kernels and derive the operand
        # copies before accepting traffic.
        self._worker.submit(self._warm).result()

    def _warm(self) -> None:
        dummy = torch.zeros(1, self.image_size, self.image_size, 3,
                            device=self.device)
        for gen in (self.fwd, self.rev):
            if gen is not None:
                gen(dummy, policy=self.policy).cpu()

    def translate(self, img: np.ndarray, reconstruct: bool = False) -> np.ndarray:
        """(H,W,3) float image in [0,1] -> (H,W,3) float32 in [0,1]."""
        if reconstruct and self.rev is None:
            raise RuntimeError("reverse generator checkpoint not found")
        x = torch.as_tensor(np.asarray(img, np.float32))[None]
        return self._worker.submit(self._translate, x, reconstruct).result()

    def _translate(self, x: torch.Tensor, reconstruct: bool) -> np.ndarray:
        x = x.to(self.device)
        t0 = time.perf_counter()
        y = self.fwd(x, policy=self.policy)
        if reconstruct:
            y = self.rev(y, policy=self.policy)
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
        return {"requests": self.count,
                "p50_ms": pct(0.5), "p99_ms": pct(0.99)}


def make_handler(translator, args):
    from PIL import Image, UnidentifiedImageError

    from ..data.preprocess import preprocess_array

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
                self._json(200, {"status": "ok", "direction": args.direction,
                                 "image_size": args.image_size,
                                 "device": str(translator.device)})
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
    translator = Translator(args.model_path, args.direction, args.image_size,
                            args.precision, args.device)
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
