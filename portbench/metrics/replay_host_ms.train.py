"""Host ms inside the CUDA graphs' replays an iteration, over every replay
of the process: the program's counter (train/chunk.py ``host_ns["replay"]``,
host nanoseconds inside ``graph.replay()``) over its replays (one an
iteration). Those are the checked steps', the warm chunks', the window's
and the profiled chunks' replays, the last slower under the profiler;
nothing where the program keeps no such counter."""

import sys


def read(s: dict):
    chunk = sys.modules.get("discogan_modernized_torch.train.chunk")
    host = getattr(chunk, "host_ns", None)
    if s["device_type"] != "cuda" or not host or not host.get("replay"):
        return None
    return host["replay"] / 1e6 / sum(chunk.replays.values())
