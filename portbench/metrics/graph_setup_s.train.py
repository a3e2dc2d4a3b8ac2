"""Host seconds of set-up in the chunk program: its eager step bodies and
its graphs' captures, instantiation included (train/chunk.py
``host_ns["eager"]`` and ``host_ns["capture"]``), the kernel library's
build or load left out (the program does it when it is made); nothing
where the program keeps no such counter or captured no graph."""

import sys


def read(s: dict):
    host = getattr(sys.modules.get("discogan_modernized_torch.train.chunk"), "host_ns", None)
    if s["device_type"] != "cuda" or not host or not host.get("capture"):
        return None
    return (host["eager"] + host["capture"]) / 1e9
