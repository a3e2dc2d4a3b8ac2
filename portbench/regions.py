"""The traced sub-window's device time by the program's spans: which part
of the train step (the optimizer, the weight casts, the BatchNorm and
activation backward, the rest of each step) each replayed kernel belongs
to.

A span on the host cannot see inside a CUDA graph: a replay's kernels run
under one ``cudaGraphLaunch``. So each step kind the sub-window ran is run
twice more, eagerly, under a second profiler session (a
``ChunkProgram(..., graphs=False)`` on the bench's state and data, after
the window, where the state no longer matters). There each device
operation (kernel, memset, device-side copy) takes the innermost program
span (``discogan.<name>``, the port's core/trace.py) open on the thread
that launched it, at the launch, found through the profiler's link
between the operation and the host operation open at its launch (else
its runtime call); an operation launched where
that thread has no span open (the autograd engine's thread outside
``bn_backward``) takes the main thread's innermost span at that moment.
Only operations under the last ``step.<kind>`` span of each kind count.

Each replay of the sub-window is the device operations that share the
correlation of one ``cudaGraphLaunch``, ordered by their device start; the
launches in order ran the sub-window's iterations in order, so each has
its iteration's kind. A replay's operations must equal its kind's eager
operations one for one, name for name (a device-to-device copy or a memset
matches one of its own kind: a graph runs a copy as a kernel of another
name); their durations are then summed by label. Where any replay differs
in count or name there are no regions, and the first difference is
printed on standard error. Eager durations are never used.

``measure(bench, events, it0, it1)`` gives the summary key ``regions``:
label -> {"ms", "ops"}, device ms and device operations an iteration over
the replays of iterations it0 .. it1 - 1, ``step.<kind>`` the step's own
operations outside the inner spans.

Run alone, it builds a cell as its driver does, runs the checked steps and
the traffic's warm chunks, profiles its ``trace_chunks`` chunks and prints
the regions, the device time they sum to beside the replays' and the
profile's busy time, the seconds the pass took, and the program's host
counters: the eager bodies' and the captures' seconds, and host ms in the
graphs' replays an iteration over ``HOST_CHUNKS`` further chunks run with
no profiler. Until the traced run calls ``measure`` itself, this runner
stands in for it, and goes when that call is made:

    python3 portbench/regions.py --workload <cell> --seed <n>
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

PREFIX = "discogan."  # the program's spans (core/trace.py)
STEP = "step."
ANNOTATIONS = (PREFIX, "portbench.")  # host spans, never device operations
GRAPH_LAUNCH = "cudaGraphLaunch"
HOST_CHUNKS = 8  # chunks after the profile for the replays' host ms (~2 s)


class Event(NamedTuple):
    """What the labelling reads of one profiler event."""
    name: str
    on_device: bool
    start: int
    end: int
    corr: int  # on the device and in a runtime call: the runtime's correlation
    link: int  # on the device: the host operation that launched it
    tid: int


def events_of(kineto_events) -> list:
    """The profiler's events (``prof.profiler.kineto_results.events()``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [Event(e.name(), e.device_type() == cuda, e.start_ns(), e.end_ns(),
                  e.correlation_id(), e.linked_correlation_id(), e.start_thread_id())
            for e in kineto_events]


def op_kind(name: str) -> str:
    """A device operation's name as replays and eager runs are matched: a
    copy or a fill by its kind alone."""
    low = name.lower()
    for kind in ("memcpy", "memset"):
        if low.startswith(kind):
            return kind
    return name


def device_ops(events: list) -> list:
    """The device's operations, each once, by device start: no host span's
    range on the device's timeline."""
    ops = {e for e in events if e.on_device and e.end > e.start
           and not e.name.startswith(ANNOTATIONS)}
    return sorted(ops, key=lambda e: (e.start, e.end))


def _innermost(spans: list, t: int, tid: int | None = None):
    inside = [s for s in spans if s.start <= t < s.end and (tid is None or s.tid == tid)]
    return min(inside, key=lambda s: s.end - s.start) if inside else None


def _launch(op: Event, calls: dict, host_ops: dict):
    """(time, thread) of the host call that launched ``op``: the start of
    the host operation the profiler linked it to (the innermost one open
    at the launch, on the spans' clock), else its runtime call (on the
    runtime's clock, which may read a few microseconds off the spans')."""
    at = host_ops.get(op.link) or calls.get(op.corr)
    return (at.start, at.tid) if at else None


def label_eager(events: list) -> dict:
    """kind -> [(operation name, label)] of an eager run's device
    operations under the last ``step.<kind>`` of each kind, by device
    start."""
    host = [e for e in events if not e.on_device]
    spans = [e._replace(name=e.name[len(PREFIX):]) for e in host
             if e.name.startswith(PREFIX)]
    steps = [s for s in spans if s.name.startswith(STEP)]
    calls = {e.corr: e for e in host if e.name.startswith("cu")}
    host_ops: dict = {}  # an operation, and the profiler's own events inside it, share its id
    for e in sorted(host, key=lambda e: e.start):
        if not e.name.startswith("cu"):
            host_ops.setdefault(e.corr, e)
    last = {s.name: s for s in sorted(steps, key=lambda s: s.start)}
    out: dict = {}
    for op in device_ops(events):
        at = _launch(op, calls, host_ops)
        step = at and _innermost(steps, at[0])
        if not step or last[step.name] != step:
            continue
        t, tid = at
        span = _innermost(spans, t, tid) or _innermost(spans, t, step.tid)
        out.setdefault(step.name[len(STEP):], []).append((op.name, span.name))
    return out


def replays(events: list) -> list:
    """Each graph launch's device operations by device start, the launches
    in their host order."""
    launches = sorted((e for e in events if not e.on_device
                       and e.name.startswith(GRAPH_LAUNCH)), key=lambda e: e.start)
    by_corr: dict = {}
    for op in device_ops(events):
        by_corr.setdefault(op.corr, []).append(op)
    return [by_corr.get(launch.corr, []) for launch in launches]


def align(labels: dict, launched: list, kinds: list):
    """(regions, None), or (None, the first difference) where a replay's
    operations differ from its kind's eager ones."""
    if len(launched) != len(kinds):
        return None, f"{len(launched)} graph launches for {len(kinds)} iterations"
    ns: dict = {}
    ops: dict = {}
    for kind, got in zip(kinds, launched):
        want = labels.get(kind, [])
        for j in range(max(len(want), len(got))):
            w = want[j][0] if j < len(want) else "(none)"
            g = got[j].name if j < len(got) else "(none)"
            if op_kind(w) != op_kind(g):
                return None, (f"kind {kind}, operation {j} of {len(got)} replayed and "
                              f"{len(want)} eager: eager {w[:160]!r}, replay {g[:160]!r}")
        for (_, label), op in zip(want, got):
            ns[label] = ns.get(label, 0) + (op.end - op.start)
            ops[label] = ops.get(label, 0) + 1
    n = len(kinds)
    return {k: {"ms": ns[k] / 1e6 / n, "ops": ops[k] / n} for k in sorted(ns)}, None


def label_kinds(bench, kinds: set, it: int) -> dict:
    """Two eager iterations of each of ``kinds`` on ``bench``'s state and
    data, profiled; the labels of the second (``label_eager``): the
    profiler drops the device's events that its clock maps before the
    session's start, which on the card can take the first few ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = bench.cfg
    # the bench's chunk length: the table's shape picks PyTorch's gather kernel
    program = bench.chunk_mod.ChunkProgram(bench.ts, cfg, bench.policy, *bench.data,
                                           bench.batch, bench.steps, kinds, graphs=False)
    first = {kind: next(j for j in range(it, it + 10 ** 6) if cfg.step_kind(j) == kind)
             for kind in kinds}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for kind in 2 * sorted(kinds):
            program(*bench.feed.rows(first[kind], 1), first[kind])
        torch.cuda.synchronize(bench.device)
    return label_eager(events_of(prof.profiler.kineto_results.events()))


def measure(bench, events: list, it0: int, it1: int) -> dict:
    """The summary key ``regions`` of the profiled replays of iterations
    it0 .. it1 - 1 (``events``: ``events_of`` the sub-window's profile), or
    nothing where a replay does not match its kind's eager operations."""
    kinds = [bench.cfg.step_kind(i) for i in range(it0, it1)]
    labels = label_kinds(bench, set(kinds), it1)
    regions, mismatch = align(labels, replays(events), kinds)
    if mismatch:
        print(f"portbench regions: a replay differs from its eager step: {mismatch}",
              file=sys.stderr)
        return {}
    return {"regions": regions}


def report(regions: dict) -> str:
    return ("portbench trace: ms and operations an iteration by span "
            + json.dumps({k: [round(v["ms"], 4), round(v["ops"], 2)]
                          for k, v in sorted(regions.items())}))


def _union_ns(ops: list) -> int:
    total, end = 0, None
    for op in sorted(ops, key=lambda e: e.start):
        if end is None or op.start > end:
            total, end = total + op.end - op.start, op.end
        elif op.end > end:
            total, end = total + op.end - end, op.end
    return total


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)

    import portbench.run  # noqa: F401 - the run's caches and compute thread, as a run sets them
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness

    spec = harness.cell_spec(args.workload, portbench.run.ROOT)
    if not torch.cuda.is_available():
        print("portbench regions: no CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    b = harness.driver(spec).Bench(spec, args.seed, device)
    b.checked_steps()
    it = 3
    for _ in range(spec["traffic"].get("warm_chunks", 0)):
        it += b.chunk(it)[0]
    torch.cuda.synchronize(device)
    counters = b.chunk_mod.host_ns
    eager_s, capture_s = counters["eager"] / 1e9, counters["capture"] / 1e9

    it0 = it
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(spec["traffic"]["trace_chunks"]):
            it += b.chunk(it)[0]
        torch.cuda.synchronize(device)
    events = events_of(prof.profiler.kineto_results.events())
    it1 = it

    replay_ns, replayed = counters["replay"], sum(b.chunk_mod.replays.values())
    for _ in range(HOST_CHUNKS):
        it += b.chunk(it)[0]
    torch.cuda.synchronize(device)
    replay_host_ms = ((counters["replay"] - replay_ns) / 1e6
                      / (sum(b.chunk_mod.replays.values()) - replayed))

    t0 = time.perf_counter()
    out = measure(b, events, it0, it1)
    pass_s = time.perf_counter() - t0
    n = it1 - it0
    replayed_ops = [op for group in replays(events) for op in group]
    result = {"iterations": n, "regions": out.get("regions"),
              "labels_ms": sum(v["ms"] for v in out.get("regions", {}).values()),
              "replay_ms": sum(op.end - op.start for op in replayed_ops) / 1e6 / n,
              "busy_ms": _union_ns(device_ops(events)) / 1e6 / n,
              "eager_s": eager_s, "capture_s": capture_s,
              "replay_host_ms": replay_host_ms, "region_pass_s": pass_s,
              "device": torch.cuda.get_device_name(device)}
    if "regions" in out:
        print(report(out["regions"]), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0 if "regions" in out else 1

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
