"""What decides ``correct``: the reference against the port's CPU path at a
tiny size, the control coming out not correct, and the run with its timed
path broken underneath coming out not correct (a state left unchanged;
half of each batch left out)."""

from __future__ import annotations

import pytest
import torch

from tiny import run_tiny, tiny_spec

from portbench import check, harness
from portbench.drivers import train_chunked as drv


@pytest.mark.parametrize("config,slim_state", [("discogan64", None), ("discogan64", "off"),
                                               ("discogan512", None)],
                         ids=["mv", "off", "all"])
def test_reference_holds_the_port_cpu_path(config, slim_state):
    """In f32 on the CPU the port and the reference agree far inside the
    cell's limits, under each slim state the port has (mv, off, and all,
    the 512px configuration's, whose gradients are bf16, the masters'
    dtype)."""
    out = run_tiny(tiny_spec(config=config, slim_state=slim_state), seed=2 ** 31 + 3)
    numbers = {k: c["value"] for k, c in out["checks"].items()}
    assert numbers["loss_gap"] < 1e-3
    assert numbers["grad_gap"] < 2e-2
    assert numbers["change_gap"] < 2e-2
    assert numbers["dgrad_median_gap"] < 1e-3
    assert out["correct"]


def _control_verdict(config: str, precision: str) -> bool:
    spec = tiny_spec(config=config)
    cpu = torch.device("cpu")
    b = drv.Bench(spec, 11, cpu)
    batches = b.batches()
    b.free()
    ref = drv.reference_readings(spec, 11, batches, cpu)
    low = drv.reference_readings(spec, 11, batches, cpu, precision=precision)
    return harness.judge(check.gaps(low, ref), spec["cell"]["limits"])[0]


@pytest.mark.parametrize("config", ["discogan64", "discogan512"])
def test_the_fp8_control_is_not_correct(config):
    assert not _control_verdict(config, "fp8")


def test_a_state_left_unchanged_is_not_correct(monkeypatch):
    from discogan_modernized_torch.train import optim

    monkeypatch.setattr(optim.Adam, "apply", lambda self, grads, bc, seeds: None)
    out = run_tiny(tiny_spec())
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from discogan_modernized_torch.train import chunk

    whole = chunk.loss_and_grads

    def half(ts, A, B, *args, **kwargs):
        return whole(ts, A[: len(A) // 2], B[: len(B) // 2], *args, **kwargs)

    monkeypatch.setattr(chunk, "loss_and_grads", half)
    out = run_tiny(tiny_spec(batch=8))
    assert not out["correct"], out["checks"]


def test_a_number_that_is_not_finite_fails():
    ok, checks = harness.judge({"loss_gap": float("nan")}, {"loss_gap": 1.0})
    assert not ok and list(checks) == ["loss_gap"]
    prog = {"losses": [1.0, 1.0, float("nan")], "grad_norms": {"dis": [1.0], "gen": [1.0]},
            "change_norms": {"dis": [1.0], "gen": [1.0]}}
    ref = {"losses": [1.0] * 3, "grad_norms": {"dis": [1.0], "gen": [1.0]},
           "change_norms": {"dis": [1.0], "gen": [1.0]}}
    assert check.gaps(prog, ref)["loss_gap"] != check.gaps(prog, ref)["loss_gap"]
