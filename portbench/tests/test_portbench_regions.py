"""regions.py on synthetic profiler events: the eager run's labels by the
innermost program span (and the autograd thread's fallback to the main
thread's), the replays' alignment with them and the sums by label, a
mismatch that leaves the regions out, a summary whose keys stay as they
were, and the program-counter readers on a CPU and a card summary."""

from __future__ import annotations

import copy
import sys
import types

import pytest

from tiny import ROOT  # noqa: F401 - puts the checkout on the path

from portbench import harness, regions, tracing
from portbench.regions import Event

MAIN, AUTOGRAD = 1, 2
# (name, launch time, launching thread, eager label)
EAGER = [("index_select_kernel", 5, MAIN, "step.gen"),
         ("cast_kernel", 20, MAIN, "cast"),
         ("Memcpy DtoD (Device -> Device)", 30, MAIN, "cast"),
         ("conv_kernel", 200, MAIN, "step.gen"),
         ("act_backward_kernel", 250, AUTOGRAD, "step.gen"),  # no span of its own
         ("bn_backward_kernel", 310, AUTOGRAD, "bn_backward"),
         ("dw_kernel", 450, AUTOGRAD, "step.gen"),
         ("adam_kernel", 700, MAIN, "adam"),
         ("Memset (Device)", 710, MAIN, "adam")]
SPANS = [("step.gen", 0, 1000, MAIN), ("cast", 10, 100, MAIN),
         ("bn_backward", 300, 400, AUTOGRAD), ("adam", 600, 900, MAIN)]


def eager_events(shift: int = 0) -> list:
    """A step's spans, runtime calls and device operations, the step at
    ``shift``; one more kernel launched after the step, which no label
    takes, and the device-side ranges of the spans."""
    out = [Event("discogan." + n, False, s + shift, e + shift, 900 + k, 0, tid)
           for k, (n, s, e, tid) in enumerate(SPANS)]
    out += [Event("discogan." + n, True, s + shift + 5000, e + shift + 5000, 900 + k, 0, MAIN)
            for k, (n, s, e, tid) in enumerate(SPANS)]
    for k, (name, t, tid, _) in enumerate(EAGER + [("late_kernel", 1100, MAIN, None)]):
        corr = 100 + k
        out.append(Event("cudaLaunchKernel", False, t + shift, t + shift + 3, corr, 50 + k, tid))
        out.append(Event(name, True, 5000 + shift + 10 * k, 5000 + shift + 10 * k + 4,
                         corr, 50 + k, tid))
    return out


def replay_events(names: list, durations: list, corr: int, t: int) -> list:
    """One graph launch at ``t`` and its operations, all under its
    correlation."""
    out = [Event("cudaGraphLaunch", False, t, t + 2, corr, 0, MAIN)]
    dev = 10 * t
    for name, d in zip(names, durations):
        out.append(Event(name, True, dev, dev + d, corr, 0, MAIN))
        dev += d + 1
    return out


def graph_names(eager=EAGER):
    """The eager names as a graph's replay reports them (its copy a kernel)."""
    return ["memcpy32_post" if n.startswith("Memcpy") else n for n, *_ in eager]


def test_labels_by_the_innermost_span_with_the_autograd_fallback():
    labels = regions.label_eager(eager_events())
    assert labels == {"gen": [(n, label) for n, _, _, label in EAGER]}


def test_only_the_last_step_of_a_kind_is_labelled():
    # a first step whose first operations the profiler dropped, then a whole one
    first = [e for e in eager_events() if not (e.on_device and e.name == "index_select_kernel")]
    second = [e._replace(corr=e.corr + 10_000, link=e.link + 10_000 if e.link else 0)
              for e in eager_events(shift=2000)]
    assert regions.label_eager(first + second) == regions.label_eager(eager_events())


def test_the_linked_host_operation_decides_over_the_runtime_clock():
    events = eager_events()
    # the first kernel's runtime call reads before its step began (the
    # runtime's clock); the host operation it is linked to is inside
    first = next(e for e in events if e.name == "index_select_kernel")
    events = [e._replace(start=-4) if e.name == "cudaLaunchKernel" and e.corr == first.corr
              else e for e in events]
    events.append(Event("aten::index_select", False, 3, 9, first.link, 0, MAIN))
    # and the adam kernel's call reads before adam's span, its operation inside
    adam = next(e for e in events if e.name == "adam_kernel")
    events = [e._replace(start=590) if e.name == "cudaLaunchKernel" and e.corr == adam.corr
              else e for e in events]
    events.append(Event("aten::mul", False, 690, 720, adam.link, 0, MAIN))
    assert regions.label_eager(events) == regions.label_eager(eager_events())


def test_a_device_operation_without_a_runtime_call_takes_its_linked_host_operation():
    events = eager_events()
    # the adam kernel's runtime call is missing; its host operation remains
    adam = next(e for e in events if e.name == "adam_kernel")
    events = [e for e in events if not (e.name == "cudaLaunchKernel" and e.corr == adam.corr)]
    events.append(Event("aten::mul", False, 690, 720, adam.link, 0, MAIN))
    assert regions.label_eager(events)["gen"][7] == ("adam_kernel", "adam")


def test_alignment_sums_each_label_an_iteration():
    labels = regions.label_eager(eager_events())
    durations = [[1000 * (k + 1) for k in range(len(EAGER))], [3000] * len(EAGER)]
    events = (replay_events(graph_names(), durations[0], 700, 10)
              + replay_events(graph_names(), durations[1], 701, 20)
              + [Event("Memcpy HtoD (Pinned -> Device)", True, 1, 5, 3, 0, MAIN)])
    got, mismatch = regions.align(labels, regions.replays(events), ["gen", "gen"])
    assert mismatch is None
    want_ns: dict = {}
    for (_, _, _, label), a, b in zip(EAGER, *durations):
        want_ns[label] = want_ns.get(label, 0) + a + b
    assert got == {k: {"ms": v / 1e6 / 2, "ops": sum(lab == k for *_, lab in EAGER)}
                   for k, v in want_ns.items()}
    # the labels' time is the replays' device time
    replayed = sum(sum(d) for d in durations)
    assert sum(v["ms"] for v in got.values()) * 2 == pytest.approx(replayed / 1e6)


@pytest.mark.parametrize("change", ["name", "count", "launches"])
def test_a_mismatch_leaves_the_regions_out(change, capsys, monkeypatch):
    labels = regions.label_eager(eager_events())
    names, kinds = graph_names(), ["gen", "gen"]
    if change == "name":
        names[3] = "another_conv_kernel"
    elif change == "count":
        names = names[:-1]
    else:
        kinds = ["gen", "gen", "gen"]
    events = (replay_events(graph_names(), [5] * len(EAGER), 700, 10)
              + replay_events(names, [5] * len(names), 701, 20))
    got, mismatch = regions.align(labels, regions.replays(events), kinds)
    assert got is None and mismatch
    if change == "name":
        assert "kind gen, operation 3" in mismatch and "another_conv_kernel" in mismatch

    monkeypatch.setattr(regions, "label_kinds", lambda *a: labels)
    bench = types.SimpleNamespace(cfg=types.SimpleNamespace(step_kind=lambda i: kinds[i]))
    assert regions.measure(bench, events, 0, len(kinds)) == {}
    assert "a replay differs" in capsys.readouterr().err


class _Kineto:
    """A profiler event as tracing.summarize reads it."""

    def __init__(self, name, cuda, start, end):
        import torch

        self._v = (name, torch.autograd.DeviceType.CUDA if cuda
                   else torch.autograd.DeviceType.CPU, start, end)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[3] - self._v[2]


def test_the_existing_summary_keys_stay_as_they_were(monkeypatch):
    labels = regions.label_eager(eager_events())
    events = (replay_events(graph_names(), [7] * len(EAGER), 700, 10)
              + replay_events(graph_names(), [9] * len(EAGER), 701, 20))
    kineto = ([_Kineto("portbench.chunk", False, 0, 400), _Kineto("portbench.sync", False, 0, 450)]
              + [_Kineto(e.name, e.on_device, e.start, e.end) for e in events])
    summary = tracing.summarize(kineto, harness.kernel_classes())
    before = copy.deepcopy(summary)
    monkeypatch.setattr(regions, "label_kinds", lambda *a: labels)
    bench = types.SimpleNamespace(cfg=types.SimpleNamespace(step_kind=lambda i: "gen"))
    summary.update(regions.measure(bench, events, 0, 2))
    assert set(summary) == set(before) | {"regions"}
    assert {k: summary[k] for k in before} == before
    assert sum(v["ops"] for v in summary["regions"].values()) == len(EAGER)


@pytest.fixture()
def counters(monkeypatch):
    """The program's chunk module with its counters as after a card run."""
    chunk = types.ModuleType("discogan_modernized_torch.train.chunk")
    chunk.replays = {"dis": 10, "lean": 0, "gen": 20}
    chunk.host_ns = {"replay": 30 * 9_000_000, "eager": 2_500_000_000,
                     "capture": 1_500_000_000}
    monkeypatch.setitem(sys.modules, chunk.__name__, chunk)
    return chunk


@pytest.mark.parametrize("name,want", [("replay_host_ms.train", 9.0),
                                       ("graph_setup_s.train", 4.0)])
def test_program_counter_readers(name, want, counters):
    read = harness.reader(name)
    assert read({"device_type": "cpu"}) is None
    assert read({"device_type": "cuda"}) == pytest.approx(want)
    del counters.host_ns  # the parent's program keeps no such counter
    assert read({"device_type": "cuda"}) is None


@pytest.mark.parametrize("name", ["replay_host_ms.train", "graph_setup_s.train"])
def test_program_counter_readers_on_a_cpu_run(name, counters):
    counters.host_ns.update(replay=0, capture=0)  # the CPU's eager steps only
    assert harness.reader(name)({"device_type": "cuda"}) is None
    assert harness.reader(name)({"device_type": "cpu"}) is None
