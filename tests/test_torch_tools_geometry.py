"""The port's timing tools' geometry and counts against the JAX package's
tools, on the CPU: the layer tables of ``fwd_profile`` and
``step_itemize``, the conv accounting's step multiplicities, the analytic
FLOP count that ``roofline`` uses (against ``torch.utils.flop_counter`` on
the plain PyTorch calls, and against XLA's count of the conv of
``tests/test_roofline.py``), and ``memory_report``'s parameter and state
bytes (``tests/test_memory_analysis.py``'s properties, on the port)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from discogan_modernized_torch.tools import fwd_profile, memory_report, roofline
from discogan_modernized_torch.tools import step_itemize as si
from discogan_modernized_tpu.tools import fwd_profile as jax_fwd_profile
from discogan_modernized_tpu.tools import step_itemize as jax_si

SIZES = (64, 512)


@pytest.mark.parametrize("size", SIZES)
def test_layer_tables_equal_jax(size):
    assert fwd_profile.layer_table(size) == jax_fwd_profile.layer_table(size)
    assert si._gen_layers(size) == jax_si._gen_layers(size)
    assert si._dis_layers(size) == jax_si._dis_layers(size)


@pytest.mark.parametrize("size", SIZES)
def test_conv_accounting_multiplicities_equal_jax(size, monkeypatch):
    """The JAX tool's conv_accounting, its timings replaced by one distinct
    number a layer and mode, sums to the port's ``account`` of the same
    numbers for the G step, the lean D step and the forward alone."""
    rows = jax_si._gen_layers(size) + jax_si._dis_layers(size)
    rng = np.random.RandomState(size)
    fake = {name: tuple(float(v) for v in rng.randint(1, 10**6, size=5))
            for name, *_ in rows}
    by_shape = {}
    for name, kind, s, cin, cout, epi in rows:
        by_shape.setdefault((kind, s, cin, cout), []).append(name)
    calls = {"modes": {}, "epi": {}}

    def modes(kind, s, cin, cout, batch, dtype, timed):
        key = (kind, s, cin, cout)
        i = calls["modes"].get(key, 0)
        calls["modes"][key] = i + 1
        return fake[by_shape[key][i]][:3]

    def epilogue(kind, s, cin, cout, batch, dtype, epi, timed):
        key = (kind, s, cin, cout)
        i = calls["epi"].get(key, 0)
        calls["epi"][key] = i + 1
        return fake[by_shape[key][i]][3:]

    monkeypatch.setattr(jax_si, "time_layer_modes", modes)
    monkeypatch.setattr(jax_si, "time_layer_epilogue", epilogue)
    want = jax_si.conv_accounting(size, 8, jnp.bfloat16, n1=1, n2=2, reps=1)
    gen_rows, dis_rows = si._gen_layers(size), si._dis_layers(size)
    for which in ("gen", "dis", "fwd"):
        conv_us, epi_us = si.account(fake, gen_rows, dis_rows, which)
        assert conv_us == pytest.approx(want[f"{which}_conv_us"], rel=1e-12)
        assert epi_us == pytest.approx(want[f"{which}_epi_us"], rel=1e-12)


def _counted(fn, *args) -> int:
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("kind, size, cin, cout", [
    ("conv", 16, 8, 16), ("conv", 8, 3, 32), ("latent", 4, 32, 100),
    ("latent_t", 1, 100, 32), ("convt", 4, 32, 16), ("head", 8, 16, 3)])
def test_layer_flops_equal_the_flop_counter(kind, size, cin, cout):
    """The analytic count of one layer op equals FlopCounterMode's on the
    plain F.conv2d / F.conv_transpose2d of the same shapes."""
    n = 2
    if kind in ("conv", "latent"):
        stride, pad = (2, 1) if kind == "conv" else (1, 0)
        x = torch.zeros(n, cin, size, size)
        w = torch.zeros(cout, cin, 4, 4)
        got = _counted(lambda: F.conv2d(x, w, stride=stride, padding=pad))
    else:
        stride, pad = (1, 0) if kind == "latent_t" else (2, 1)
        x = torch.zeros(n, cin, size, size)
        w = torch.zeros(cin, cout, 4, 4)
        got = _counted(lambda: F.conv_transpose2d(x, w, stride=stride, padding=pad))
    assert si.layer_flops(kind, size, cin, cout, n) == got


def test_conv_flops_near_xla():
    """tests/test_roofline.py's conv (8x16x16x32 -> 64, k4 s2): the port's
    count within that test's 15% of XLA's cost analysis where the CPU
    build reports flops."""
    from discogan_modernized_tpu.tools.roofline import compiled_report

    x = jnp.zeros((8, 16, 16, 32), jnp.float32)
    w = jnp.zeros((4, 4, 32, 64), jnp.float32)
    f = jax.jit(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    rep = compiled_report(f.lower(x, w).compile(), measured_ms=1.0)
    ours = si.layer_flops("conv", 16, 32, 64, 8)
    assert ours == 8 * 8 * 8 * 64 * 4 * 4 * 32 * 2
    if rep["flops"]:
        assert ours == pytest.approx(rep["flops"], rel=0.15)


def test_roofline_counts_follow_the_multiplicities():
    """A G step counts 4 generator forwards, dx and dw of them (2 enc0 dx),
    and 4 + 2 dx of the discriminators; the full D step 4 generator
    forwards where the lean one runs 2."""
    size, batch = 64, 4
    gen, dis = si._gen_layers(size), si._dis_layers(size)

    def fl(rows):
        return [si.layer_flops(k, s, ci, co, batch) for _, k, s, ci, co, _ in rows]

    g, d = fl(gen), fl(dis)
    gen_step = roofline.step_counts(size, batch, 2, "mv", "gen")["flops"]
    assert gen_step == 12 * sum(g) - 2 * g[0] + 6 * sum(d)
    lean = roofline.step_counts(size, batch, 2, "mv", "lean")["flops"]
    full = roofline.step_counts(size, batch, 2, "mv", "dis")["flops"]
    assert lean == 2 * sum(g) + 12 * sum(d) - 4 * d[0]
    assert full - lean == 2 * sum(g)
    off = roofline.step_counts(size, batch, 2, "off", "gen")["io_bytes_lo"]
    mv = roofline.step_counts(size, batch, 2, "mv", "gen")["io_bytes_lo"]
    gen_p = sum(p.numel() for p in _nets(size)["gen_A"].parameters())
    assert off - mv == 2 * gen_p * 4 * 2  # two generators' moments, read and written


def _nets(size):
    from discogan_modernized_torch.models.discriminator import Discriminator
    from discogan_modernized_torch.models.generator import Generator

    with torch.device("meta"):
        return {"gen_A": Generator(size), "dis_A": Discriminator(size)}


# -- memory_report ------------------------------------------------------------

def _report(**kw):
    return memory_report.analyze(64, 8, ["single", "dp", "gspmd", "spatial"], **kw)


def test_memory_report_keys():
    rep = _report()
    for key in ("image_size", "global_batch", "n_devices", "tp", "slim_state", "modes"):
        assert key in rep
    assert set(rep["modes"]) == {"single", "dp", "gspmd", "spatial"}


@pytest.mark.parametrize("slim", [None, "mv", "all"])
def test_memory_report_tp_splits_the_state(slim):
    """Under TP each sharded parameter and its moments hold 1/tp a rank;
    the rest stay whole; spatial keeps every parameter whole."""
    from discogan_modernized_torch.parallel.gspmd import shard_spec

    tp = 2
    rep = _report(tp=tp, slim_state=slim)
    single, gspmd, spatial = (rep["modes"][m] for m in ("single", "gspmd", "spatial"))
    nets = _nets(64)
    whole = split = 0
    for net in nets.values():
        for name, p in net.named_parameters():
            if shard_spec(net, name, tp) is None:
                whole += p.numel()
            else:
                split += p.numel()
    p_item = 2 if slim == "all" else 4
    assert gspmd["param_bytes"] == 2 * (whole + split // tp) * p_item
    assert single["param_bytes"] == 2 * (whole + split) * p_item
    assert gspmd["param_bytes"] < 0.6 * single["param_bytes"]
    assert gspmd["opt_bytes"] / single["opt_bytes"] == pytest.approx(
        gspmd["param_bytes"] / single["param_bytes"])
    assert spatial["param_bytes"] == single["param_bytes"]
    assert spatial["opt_bytes"] == single["opt_bytes"]
    assert spatial["activation_bytes"] * tp <= rep["modes"]["gspmd"]["activation_bytes"] + tp


def test_memory_report_slim_halves_the_state():
    off, mv = _report(slim_state=None), _report(slim_state="mv")
    for mode in ("single", "dp", "gspmd", "spatial"):
        assert mv["modes"][mode]["opt_bytes"] * 2 == off["modes"][mode]["opt_bytes"]
        assert mv["modes"][mode]["param_bytes"] == off["modes"][mode]["param_bytes"]


@pytest.mark.parametrize("slim", [None, "mv", "all"])
def test_memory_report_single_equals_jax_leaves(slim):
    """The one-process parameter and optimizer bytes equal the sum of the
    JAX train state's leaves (its models; both Adam states' m and v) for
    the same config."""
    from discogan_modernized_tpu.train.step import TrainConfig, init_train_state

    cfg = TrainConfig(image_size=64, slim_state=slim)
    ts = jax.eval_shape(lambda k: init_train_state(k, cfg), jax.random.PRNGKey(0))

    def nbytes(tree):
        return sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                   for leaf in jax.tree.leaves(tree))

    opt = sum(nbytes(ts[k][mv]) for k in ("opt_gen", "opt_dis") for mv in ("m", "v"))
    single = _report(slim_state=slim)["modes"]["single"]
    assert single["param_bytes"] == nbytes(ts["models"])
    assert single["opt_bytes"] == opt
