"""``--profile DIR``: a ``torch.profiler`` trace of a window of training
iterations (the port of the JAX package's ``train/profiling.py``).

The window skips the first iterations (their warm-up and, on the chunked
path, the captures would fill the trace) and stops after ``n_iters`` so
the trace stays small. It records CUDA and CPU activity on the card and
CPU activity on the CPU, and writes one Chrome trace (JSON, for
``chrome://tracing`` or Perfetto) into DIR. A start or stop that fails
prints a warning and training goes on.
"""

from __future__ import annotations

from pathlib import Path

import torch


class ProfileWindow:
    """A trace of iterations [start, start + n_iters) of a run on
    ``device``; nothing where ``trace_dir`` is None."""

    def __init__(self, trace_dir: str | None, device, start: int = 2, n_iters: int = 8):
        self.trace_dir = trace_dir
        self.device = torch.device(device)
        self.start, self.end = start, start + n_iters
        self.first = None  # the first iteration inside the trace
        self.prof = None
        self.done = trace_dir is None

    def tick(self, iters: int) -> None:
        """Call at the start of each iteration, or of each chunk, with its
        first iteration."""
        if self.done:
            return
        if self.prof is None and iters >= self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            except Exception as e:  # noqa: BLE001 - the trace is optional
                print(f"경고: 프로파일 트레이스 시작 실패: {e}")
                self.done = True
                return
            self.prof, self.first = prof, iters
        if self.prof is not None and iters >= self.end:
            self.stop(iters)

    def stop(self, iters: int | None = None) -> None:
        """Idempotent; also called when the loop ends, so a short run still
        writes its trace. ``iters``: the first iteration left out."""
        if self.prof is None:
            self.done = True
            return
        prof, self.prof, self.done = self.prof, None, True
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            prof.stop()
            out = Path(self.trace_dir)
            out.mkdir(parents=True, exist_ok=True)
            last = "end" if iters is None else iters - 1
            path = out / f"trace_iters_{self.first}-{last}.json"
            prof.export_chrome_trace(str(path))
            print(f"프로파일 트레이스 저장: {path} (chrome://tracing 또는 Perfetto 로 열기)")
        except Exception as e:  # noqa: BLE001 - the trace is optional
            print(f"경고: 프로파일 트레이스 종료 실패: {e}")
