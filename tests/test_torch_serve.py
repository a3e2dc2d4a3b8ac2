"""The port's serving daemon and inference CLI against JAX eval.

gen_A_final.pth / gen_B_final.pth are written at 16px from JAX
``generator_init`` (numpy-seeded random running statistics) +
``generator_to_state_dict`` + ``torch.save``. The port runs on the CPU in
f32; its outputs match JAX ``generator_apply(training=False)`` within 1e-4,
and its PNG responses match JAX's output quantized the same way within one
level of uint8 (the 1e-4 difference may cross a rounding boundary).
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from discogan_modernized_tpu.data.preprocess import preprocess_array as jax_preprocess
from discogan_modernized_tpu.models.generator import generator_apply, generator_init
from discogan_modernized_tpu.models.torch_compat import generator_to_state_dict
from tests.test_torch_generator import random_stats
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = 16


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve_ckpt")
    gens = {}
    for seed, name in enumerate(("gen_A", "gen_B")):
        params, state = generator_init(jax.random.PRNGKey(seed), SIZE)
        state = random_stats(state, np.random.RandomState(10 + seed))
        sd = generator_to_state_dict(params, state)
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   d / f"{name}_final.pth")
        gens[name] = (params, state)
    return d, gens


def jax_eval(gen, x):
    y, _ = generator_apply(gen[0], gen[1], np.asarray(x)[None], training=False)
    return np.asarray(y)[0]


@pytest.fixture(scope="module")
def server(checkpoint):
    from discogan_modernized_torch.tools.serve import parse_args, serve

    pytest.importorskip("PIL", reason="the HTTP handler decodes with PIL")
    d, _ = checkpoint
    args = parse_args([f"--model_path={d}", f"--image_size={SIZE}", "--port=0",
                       "--device=cpu", "--precision=f32"])
    srv, translator = serve(args)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", translator
    srv.shutdown()
    srv.server_close()
    translator.close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_translator_arrays_match_jax(checkpoint):
    from discogan_modernized_torch.tools.serve import Translator

    d, gens = checkpoint
    tr = Translator(d, "AtoB", SIZE, precision="f32", device="cpu")
    x = np.random.RandomState(0).rand(SIZE, SIZE, 3).astype(np.float32)
    fwd = jax_eval(gens["gen_B"], x)
    np.testing.assert_allclose(tr.translate(x), fwd, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tr.reconstruct(x), jax_eval(gens["gen_A"], fwd),
                               atol=1e-4, rtol=1e-4)
    assert tr.stats()["requests"] == 2
    tr.close()


def test_translator_runs_device_work_on_one_thread(checkpoint):
    """Requests arrive on fresh threads; the forward runs on the one worker."""
    from discogan_modernized_torch.tools.serve import Translator

    d, _ = checkpoint
    tr = Translator(d, "AtoB", SIZE, precision="f32", device="cpu")
    seen = []
    fwd = tr.fwd
    tr.fwd = lambda x, **kw: (seen.append(threading.get_ident()), fwd(x, **kw))[1]
    x = np.random.RandomState(1).rand(SIZE, SIZE, 3).astype(np.float32)
    callers = [threading.Thread(target=tr.translate, args=(x,)) for _ in range(3)]
    for c in callers:
        c.start()
        c.join()
    tr.close()
    assert len(seen) == 3 and len(set(seen)) == 1
    assert seen[0] not in {c.ident for c in callers}


def _png(rng_seed):
    from PIL import Image

    img = (np.random.RandomState(rng_seed).rand(32, 32, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return img, buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "image/png"})
    return urllib.request.urlopen(req, timeout=30)


def _quantize(y):
    return (np.clip(y, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("path", ["/translate", "/reconstruct"])
def test_http_matches_jax(server, checkpoint, path):
    from PIL import Image

    url, _ = server
    _, gens = checkpoint
    img, body = _png(1)
    with _post(url + path, body) as r:
        assert r.headers["Content-Type"] == "image/png"
        got = np.array(Image.open(io.BytesIO(r.read())))
    want = jax_eval(gens["gen_B"], jax_preprocess(img, None, SIZE))
    if path == "/reconstruct":
        want = jax_eval(gens["gen_A"], want)
    assert got.shape == (SIZE, SIZE, 3)
    diff = np.abs(got.astype(int) - _quantize(want).astype(int))
    assert diff.max() <= 1


def test_healthz_stats_and_bad_requests(server):
    url, translator = server
    with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["image_size"] == SIZE
    assert body["device"] == "cpu"

    _post(url + "/translate", _png(2)[1]).close()
    with urllib.request.urlopen(url + "/stats", timeout=10) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 1 and stats["p50_ms"] is not None

    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/translate", b"not an image")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=10)
    assert e.value.code == 404


def test_inference_cli(checkpoint, tmp_path, capsys):
    from PIL import Image

    from discogan_modernized_torch.cli.inference import have_matplotlib, main

    d, _ = checkpoint
    src = tmp_path / "in"
    src.mkdir()
    for i in range(2):
        Image.fromarray(_png(3 + i)[0]).save(src / f"img{i}.png")
    out = tmp_path / "out"
    rc = main([f"--model_path={d}", f"--input_path={src}", f"--output_dir={out}",
               f"--image_size={SIZE}", "--device=cpu", "--batch_size=1"])
    assert rc == 0
    assert "p50 per-image latency:" in capsys.readouterr().out
    if not have_matplotlib():
        pytest.skip("matplotlib is not installed: no panels to check")
    assert sorted(p.name for p in out.iterdir()) == ["img0_result.png",
                                                     "img1_result.png"]


def test_inference_cli_missing_checkpoint(tmp_path, capsys):
    from discogan_modernized_torch.cli.inference import main

    rc = main([f"--model_path={tmp_path}", f"--input_path={tmp_path}",
               "--device=cpu"])
    assert rc == 1
    assert "모델 로드 실패" in capsys.readouterr().out
