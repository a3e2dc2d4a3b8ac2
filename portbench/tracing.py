"""The traced sub-window: a fixed count of whole chunks under
``torch.profiler`` (CPU and CUDA activities), with the benchmark's own
spans around each chunk, its table fill, its replays and its sync, reduced
in memory to a summary that the per-layer metric readers take:

- ``window_s``: from the first chunk's span to the end of the last sync;
- ``busy_s``: the union of the device's kernels and copies in it;
- ``kernel_count`` and ``iterations``, ``kinds`` (step kinds run);
- ``classes``: device seconds of each kernel class (``classes/``), the
  union of its operations' intervals, and of the operations no class
  names (``unclassified``);
- ``breakdown``: the ten device operations that took most time, and the
  ten longest idle gaps, each named by the span the host was in when it
  began.
"""

from __future__ import annotations

import functools

import torch

from portbench import harness

SPAN = "portbench."
NAME_CHARS = 160
UNCLASSIFIED = "unclassified"  # the time of operations no class names


def _spanned(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(SPAN + name):
            return fn(*args, **kwargs)
    return wrapper


def profile_chunks(bench, it: int, n_chunks: int) -> dict:
    """Profile ``n_chunks`` whole chunks of ``bench`` (a driver's Bench)
    from iteration ``it``, each chunk and its logged losses' read in a span,
    the program's table fill and replays in spans of their own."""
    from torch.profiler import ProfilerActivity, profile

    program, cfg, device = bench.program, bench.cfg, bench.device
    program._fill = _spanned("fill", program._fill)
    program._run = _spanned("replay", program._run)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    kinds: dict = {}
    it0 = it
    with profile(activities=activities) as prof:
        for _ in range(n_chunks):
            with torch.profiler.record_function(SPAN + "chunk"):
                k, _ = bench.chunk(it)
            for i in range(it, it + k):
                kinds[cfg.step_kind(i)] = kinds.get(cfg.step_kind(i), 0) + 1
            it += k
        with torch.profiler.record_function(SPAN + "sync"):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    summary = summarize(prof.profiler.kineto_results.events(), harness.kernel_classes())
    summary.update(iterations=it - it0, kinds=kinds, device_type=device.type)
    return summary


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, classes: dict) -> dict:
    host, dev = [], []
    for e in events:
        name = e.name()
        if name.startswith(SPAN):
            if e.device_type() == torch.autograd.DeviceType.CPU:
                host.append((e.start_ns(), e.end_ns(), name[len(SPAN):]))
        elif e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
            dev.append((e.start_ns(), e.end_ns(), name))
    dev = sorted(set(dev))  # an operation reported twice counts once
    if not host:
        return {"window_s": 0.0, "busy_s": 0.0, "kernel_count": 0, "classes": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    w0 = min(s for s, _, n in host if n == "chunk")
    w1 = max(e for _, e, n in host if n == "sync")
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in dev])
    by_name: dict = {}
    spans: dict = {}  # class -> its operations' intervals
    kernels = 0
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0) + (e - s)
        found = harness.classify(n, classes)
        if "copy" not in found:
            kernels += 1
        for c in found or [UNCLASSIFIED]:
            spans.setdefault(c, []).append((s, e))
    # a class's device time: the union of its operations' intervals
    class_s = {c: sum(e - s for s, e in _union(iv)) / 1e9 for c, iv in spans.items()}
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((s - t, _span_at(host, t)))
        t = max(t, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": sum(e - s for s, e in busy) / 1e9,
            "kernel_count": kernels, "classes": class_s,
            "breakdown": {"device_ops": [[n[:NAME_CHARS], v / 1e9] for n, v in top],
                          "idle_gaps": [[n, g / 1e9] for g, n in sorted(gaps, reverse=True)[:10]]}}


def _span_at(host: list, t: int) -> str:
    """The innermost benchmark span the host was in at ``t``."""
    inside = [(e - s, n) for s, e, n in host if s <= t < e]
    return min(inside)[1] if inside else "between spans"
