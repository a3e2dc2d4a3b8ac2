"""The port's spans and host-time counters (core/trace.py, train/chunk.py)
on the CPU at 16px, through ``ChunkProgram`` as
tests/test_torch_steps_per_call.py sets it up:

- a chunk holding every step kind, under ``torch.profiler``, records
  ``discogan.step.<kind>``, ``discogan.adam``, ``discogan.cast`` and
  ``discogan.bn_backward``, each of the last three inside a step's span;
- the losses and the state after a chunk are equal bit for bit with the
  profiler on and off;
- with no profiler running, ``span`` makes no profiler call;
- the eager bodies' host time is counted, and no replay or capture on the
  CPU; ``reset_replays`` zeroes the counters;
- a program on the CPU loads no kernel library (on the card it loads it
  when made, out of the eager bodies' time).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from discogan_modernized_torch.core import trace
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.train import chunk
from discogan_modernized_torch.train.chunk import ChunkProgram
from discogan_modernized_torch.train.step import TrainConfig, init_train_state, kinds_in_range
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE, BATCH, STEPS = 16, 4, 4
# lean_dis: iterations 0-3 are one of each kind, dis, gen, gen, lean
CFG = TrainConfig(image_size=SIZE, precision="f32", slim_state="mv", lean_dis=True,
                  log_interval=6)


def _run_chunk(seed: int = 3):
    """One chunk of iterations 0-3 from a state and dataset drawn from
    ``seed``; (losses, the state's tensors)."""
    rng = np.random.RandomState(seed)
    data = [torch.from_numpy(rng.rand(12, SIZE, SIZE, 3).astype(np.float32)) for _ in "AB"]
    ia, ib = (rng.randint(0, 12, size=(STEPS, BATCH)) for _ in "AB")
    ts = init_train_state(seed, CFG)
    program = ChunkProgram(ts, CFG, F32, *data, BATCH, STEPS, kinds_in_range(CFG, 0, STEPS))
    losses = program(ia, ib, 0).clone()
    state = {f"{k}.{n}": t for k, m in ts.models.items() for n, t in m.state_dict().items()}
    for key, opt in (("gen", ts.opt_gen), ("dis", ts.opt_dis)):
        state.update({f"{key}.m{i}": t for i, t in enumerate(opt.m)})
        state.update({f"{key}.v{i}": t for i, t in enumerate(opt.v)})
    return losses, state


def _spans(prof) -> list:
    """(start, end, name) of each program span, the prefix taken off."""
    return [(e.start_ns(), e.end_ns(), e.name()[len(trace.PREFIX):])
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(trace.PREFIX)]


def test_a_chunk_records_the_program_spans_nested_in_its_steps():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_chunk()
    spans = _spans(prof)
    names = {n for _, _, n in spans}
    assert {"step.dis", "step.gen", "step.lean", "adam", "cast", "bn_backward"} <= names
    assert not [n for n in names if n.startswith("replay.")]  # no graphs on the CPU
    steps = [(s, e) for s, e, n in spans if n.startswith("step.")]
    for s, e, n in spans:
        if not n.startswith("step."):
            assert any(s0 <= s and e <= e1 for s0, e1 in steps), n
    # one body a kind, and one optimizer update an iteration
    assert sorted(n for _, _, n in spans if n.startswith("step.")) == [
        "step.dis", "step.gen", "step.gen", "step.lean"]
    assert sum(n == "adam" for _, _, n in spans) == STEPS


def test_the_profiler_changes_no_bit():
    want_losses, want = _run_chunk()
    with profile(activities=[ProfilerActivity.CPU]):
        got_losses, got = _run_chunk()
    assert torch.equal(got_losses, want_losses)
    assert got.keys() == want.keys()
    assert not [k for k in want if got[k].dtype != want[k].dtype
                or not torch.equal(got[k], want[k])]


def test_no_profiler_call_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("adam") is trace.span("cast")
    losses, _ = _run_chunk()
    assert torch.isfinite(losses).all()


def test_host_counters_count_the_eager_bodies_and_reset():
    chunk.reset_replays()
    _run_chunk()
    assert chunk.host_ns["eager"] > 0
    assert chunk.host_ns["replay"] == 0 and chunk.host_ns["capture"] == 0
    assert sum(chunk.replays.values()) == 0
    chunk.reset_replays()
    assert chunk.host_ns == {"replay": 0, "eager": 0, "capture": 0}


def test_a_program_on_the_cpu_loads_no_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library loaded for a program on the CPU")

    monkeypatch.setattr(chunk._build, "library", refuse)
    losses, _ = _run_chunk()
    assert torch.isfinite(losses).all()


@pytest.mark.parametrize("name", ["adam", "step.gen"])
def test_span_records_its_name_under_a_profiler(name):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span(name):
            torch.ones(2).sum()
    assert [n for _, _, n in _spans(prof)] == [name]
