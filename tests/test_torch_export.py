"""The port's serving artifacts (tools/export_model.py) against its eager
eval forward and the JAX package's ``jax.export`` artifacts, mirroring
tests/test_export.py, f32 on the CPU.

Weights: a 16px JAX ``generator_init`` with random running statistics,
carried into the port by ``generator_from_jax``. A port artifact equals
the port's eager forward bit for bit, static and symbolic, and the JAX
artifact's ``.call`` on the same weights within 1e-5. The exported graph
holds the ``discogan::`` nodes of K3, K5f, K2 and K6 in the counts the eval
forward calls them (at 256px, where enc1 takes K5f), and neither the plain
K3's matrix products nor a transposed convolution for the head: the guard
against an artifact of plain versions. Then the export CLI, the inference
CLI and the daemon in artifact mode with the JAX checks.
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax

from discogan_modernized_tpu.models.generator import generator_init
from discogan_modernized_tpu.models.torch_compat import generator_to_state_dict
from discogan_modernized_tpu.tools.export_model import export_generator as jax_export
from discogan_modernized_tpu.tools.export_model import load_exported as jax_load
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.generator import Generator
from discogan_modernized_torch.models.torch_compat import generator_from_jax
from discogan_modernized_torch.ops import library
from discogan_modernized_torch.tools import export_model
from tests.test_torch_generator import random_stats
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = 16
JAX_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_gen():
    params, state = generator_init(jax.random.PRNGKey(7), SIZE)
    return params, random_stats(state, np.random.RandomState(17))


def port_gen(params, state, size=SIZE) -> Generator:
    gen = Generator(size)
    gen.load_state_dict(generator_from_jax(jax.tree.map(np.asarray, params),
                                           jax.tree.map(np.asarray, state)), strict=True)
    return gen.eval()


@pytest.fixture(scope="module")
def gen16(jax_gen):
    return port_gen(*jax_gen)


def images(n, seed, size=SIZE):
    return torch.from_numpy(np.random.RandomState(seed).rand(n, size, size, 3)
                            .astype(np.float32))


def eager(gen, x):
    with torch.no_grad():
        return gen(x, policy=F32)


def save(program, path):
    torch.export.save(program, str(path))
    return path


def test_static_and_symbolic_round_trips_equal_eager_and_jax(gen16, jax_gen, tmp_path):
    """A static (batch 2) and a symbolic artifact, saved and loaded: each
    equals the eager forward bit for bit, and JAX's artifact of the same
    weights within 1e-5."""
    jexp = jax_load(jax_export(*jax_gen, SIZE, batch=0, platforms=("cpu",),
                               precision="f32"))
    static = save(export_generator16(gen16, 2), tmp_path / "b2.pt2")
    symbolic = save(export_generator16(gen16, 0), tmp_path / "b.pt2")
    assert export_model.artifact_input_shape(export_model.load_exported(static, "cpu")) == (
        2, SIZE, SIZE, 3)
    assert export_model.artifact_input_shape(export_model.load_exported(symbolic, "cpu")) == (
        None, SIZE, SIZE, 3)
    for path, batches in ((static, (2,)), (symbolic, (1, 3))):
        module = export_model.load_exported(path, "cpu").module()
        for b in batches:
            x = images(b, b)
            got = module(x)
            assert got.shape == (b, SIZE, SIZE, 3)
            assert torch.equal(got, eager(gen16, x)), (path.name, b)
            want = np.asarray(jexp.call(x.numpy()))
            np.testing.assert_allclose(got.numpy(), want, atol=JAX_TOL, rtol=0)


def export_generator16(gen, batch):
    return export_model.export_generator(gen, SIZE, batch=batch, precision="f32")


def count_serving_calls(gen, x) -> dict:
    """The eval forward's calls of each registered op, counted eagerly."""
    counts: dict = {}

    def counting(name, fn):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    names = {"conv": "conv2d_k4s2p1", "halo": "halo_conv2d_k4s2p1",
             "bn_act": "fused_batchnorm_act", "head": "head_convt_fwd"}
    ops = {k: counting(names[k], fn) for k, fn in library.SERVING_OPS.items()}
    with torch.no_grad():
        gen._eval_forward(x, F32, ops)
    return counts


def test_graph_holds_the_kernels_as_discogan_nodes():
    """At 256px (enc1 on K5f's route) the exported graph holds one
    ``discogan::`` node for each call of the eval forward, of all four
    ops, and no plain version: two matrix products (the latent conv and
    dec0, not K3's 16 per-tap products a layer) and one transposed
    convolution a wide decoder layer (none for the head, which is K6)."""
    size = 256
    gen = Generator(size, generator=torch.Generator().manual_seed(0)).eval()
    calls = count_serving_calls(gen, images(1, 0, size))
    assert set(calls) == set(library.OP_NAMES), calls
    program = export_model.export_generator(gen, size, batch=1)
    assert export_model.discogan_nodes(program) == calls
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert sum("matmul" in t for t in targets) == 2
    assert sum("conv_transpose" in t or "convolution" in t for t in targets) == \
        gen.n_halvings - 1
    assert not any(t.startswith("aten.conv2d") or "slice" in t for t in targets)


def write_checkpoint(jax_gen, d):
    sd = generator_to_state_dict(*jax_gen)
    for name in ("gen_A", "gen_B"):
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   d / f"{name}_final.pth")


def test_export_cli_from_reference_layout_and_a_missing_checkpoint(jax_gen, gen16,
                                                                   tmp_path):
    write_checkpoint(jax_gen, tmp_path)
    out = tmp_path / "artifact.pt2"
    rc = export_model.main([f"--model_path={tmp_path}", "--direction=AtoB",
                            f"--image_size={SIZE}", "--batch=1", "--precision=f32",
                            "--device=cpu", "--platforms=cpu,cuda", f"--output={out}"])
    assert rc == 0 and out.exists()
    meta = json.loads(out.with_suffix(".pt2.json").read_text())
    assert set(meta) == {"generator", "direction", "image_size", "batch", "platforms",
                         "precision", "source_checkpoint", "artifact_bytes", "created"}
    assert meta["generator"] == "gen_B" and meta["image_size"] == SIZE
    assert meta["platforms"] == ["cpu", "cuda"] and meta["precision"] == "f32"
    assert meta["artifact_bytes"] == out.stat().st_size
    x = images(1, 2)
    assert torch.equal(export_model.load_exported(out, "cpu").module()(x), eager(gen16, x))
    assert export_model.main([f"--model_path={tmp_path / 'nope'}",
                              f"--image_size={SIZE}", "--device=cpu"]) == 1


def test_loader_refuses_a_device_the_sidecar_does_not_list(jax_gen, tmp_path):
    write_checkpoint(jax_gen, tmp_path)
    out = tmp_path / "cuda_only.pt2"
    assert export_model.main([f"--model_path={tmp_path}", f"--image_size={SIZE}",
                              "--device=cpu", "--platforms=cuda", "--precision=f32",
                              f"--output={out}"]) == 0
    with pytest.raises(ValueError, match="exported for"):
        export_model.load_exported(out, "cpu")


@pytest.fixture()
def artifacts(gen16, tmp_path):
    """gen_B at batch 1 and gen_A symbolic, through the CLI (so with
    sidecars), and one input image."""
    from PIL import Image

    ck = tmp_path / "ck"
    ck.mkdir()
    torch.save(gen16.state_dict(), ck / "gen_A_final.pth")
    torch.save(gen16.state_dict(), ck / "gen_B_final.pth")
    fwd, rev = tmp_path / "gen_B.pt2", tmp_path / "gen_A.pt2"
    for direction, batch, out in (("AtoB", 1, fwd), ("BtoA", 0, rev)):
        assert export_model.main([f"--model_path={ck}", f"--direction={direction}",
                                  f"--image_size={SIZE}", f"--batch={batch}",
                                  "--precision=f32", "--device=cpu",
                                  f"--output={out}"]) == 0
    img = tmp_path / "input.png"
    Image.fromarray((np.random.RandomState(0).rand(SIZE, SIZE, 3) * 255)
                    .astype(np.uint8)).save(img)
    return fwd, rev, img, ck


def test_inference_cli_from_artifacts(artifacts, tmp_path):
    """--exported/--exported_rev run the CLI and give the checkpoint
    path's panels; a wrong --image_size and a static-batch mismatch are
    refused up front; neither --model_path nor --exported exits 2."""
    from discogan_modernized_torch.cli.inference import main as infer_main

    fwd, rev, img, ck = artifacts
    out_a, out_c = tmp_path / "out_a", tmp_path / "out_c"
    base = [f"--input_path={img}", f"--image_size={SIZE}", "--device=cpu"]
    assert infer_main([f"--exported={fwd}", f"--exported_rev={rev}",
                       f"--output_dir={out_a}", *base]) == 0
    assert infer_main([f"--model_path={ck}", f"--output_dir={out_c}",
                       "--precision=f32", *base]) == 0
    a, c = (out_a / "input_result.png").read_bytes(), (out_c / "input_result.png").read_bytes()
    assert a == c
    with pytest.raises(SystemExit, match="image_size"):
        infer_main([f"--exported={fwd}", f"--input_path={img}", "--image_size=32",
                    f"--output_dir={out_a}", "--device=cpu"])
    with pytest.raises(SystemExit, match="static batch 1"):
        infer_main([f"--exported={fwd}", "--batch_size=4", f"--output_dir={out_a}",
                    *base])
    assert infer_main([f"--output_dir={out_a}", *base]) == 2


def test_inference_cli_symbolic_artifact_batches(artifacts, tmp_path):
    """A symbolic artifact serves --batch_size 4 over 5 images: one full
    batch and one padded one, every panel written."""
    from PIL import Image

    from discogan_modernized_torch.cli.inference import main as infer_main

    _, rev, _, _ = artifacts
    src = tmp_path / "imgs"
    src.mkdir()
    for i in range(5):
        Image.fromarray((np.random.RandomState(i).rand(SIZE, SIZE, 3) * 255)
                        .astype(np.uint8)).save(src / f"im{i}.png")
    out = tmp_path / "out"
    assert infer_main([f"--exported={rev}", "--direction=BtoA", f"--input_path={src}",
                       f"--output_dir={out}", f"--image_size={SIZE}", "--batch_size=4",
                       "--device=cpu"]) == 0
    assert sorted(p.name for p in out.iterdir()) == [f"im{i}_result.png" for i in range(5)]


@pytest.mark.parametrize("flags, match", [
    (["--direction=BtoA"], "holds gen_B"),
    (["--precision=bf16"], "baked compute dtype"),
])
def test_sidecar_mismatch_exits(artifacts, tmp_path, flags, match):
    from discogan_modernized_torch.cli.inference import main as infer_main

    fwd, _, img, _ = artifacts
    with pytest.raises(SystemExit, match=match):
        infer_main([f"--exported={fwd}", f"--input_path={img}", f"--image_size={SIZE}",
                    f"--output_dir={tmp_path / 'o'}", "--device=cpu", *flags])


def test_daemon_serves_an_artifact_and_refuses_a_static_multi_batch(artifacts, gen16,
                                                                    tmp_path):
    from PIL import Image

    from discogan_modernized_torch.tools.serve import (ExportedTranslator, parse_args,
                                                       serve)

    fwd, rev, _, _ = artifacts
    srv, translator = serve(parse_args([f"--exported={fwd}", f"--exported_rev={rev}",
                                        f"--image_size={SIZE}", "--port=0",
                                        "--device=cpu"]))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.load(r)
        assert health["exported"] is True and health["direction"] == "AtoB"
        buf = io.BytesIO()
        Image.fromarray((np.random.RandomState(0).rand(SIZE, SIZE, 3) * 255)
                        .astype(np.uint8)).save(buf, format="PNG")
        for path in ("/translate", "/reconstruct"):
            req = urllib.request.Request(url + path, data=buf.getvalue(),
                                         headers={"Content-Type": "image/png"})
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
                assert Image.open(io.BytesIO(r.read())).size == (SIZE, SIZE)
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["requests"] == 2 and stats["exported"] is True
        # The daemon's worker thread has torch's default thread count, whose
        # products sum in another order than this thread's single one.
        x = images(1, 5)
        np.testing.assert_allclose(translator.translate(x[0].numpy()),
                                   eager(gen16, x)[0].numpy(), atol=1e-6, rtol=0)
    finally:
        srv.shutdown()
        srv.server_close()
        translator.close()
        t.join(timeout=10)
    b4 = save(export_generator16(gen16, 4), tmp_path / "b4.pt2")
    with pytest.raises(ValueError, match="static batch 4"):
        ExportedTranslator(b4, SIZE, device="cpu")
