"""The program's spans: named ranges of the train step on the profiler's
timeline, recorded only while a profiler runs.

``span(name)`` is ``torch.profiler.record_function("discogan." + name)``
while a ``torch.profiler`` session is running (the trainer's ``--profile
DIR``, or any caller's), and one shared null context otherwise, which
makes no profiler call. So tracing is on exactly when something profiles
the process; there is no flag for it. A span lands in the same trace as
the device operations launched inside it, on the profiler's clock, and the
profiler links each operation to the host call that launched it.

The spans, each where its work is done:

- ``step.<kind>``: one step body of kind dis, lean or gen
  (train/chunk.py), eager, or at its capture (a graph's replay has no
  span: on the card a span also puts a range on the device's timeline,
  over the kernels launched inside it, and a trace reader that takes every
  device event as an operation would count it as one);
- ``adam``: the optimizer's update (train/optim.py ``Adam.apply``);
- ``cast``: a forward's weights cast and laid out for the kernels
  (models/regions.py ``materialize``);
- ``bn_backward``: the BatchNorm and activation terms of the backward
  (ops/autograd.py), up to each conv's dy, without its dw and dx;
- ``halo``: the halo route's conv (ops/autograd.py), forward (K5f, K1 of
  its output) and backward (dy, K5b, dx; its dy inside ``bn_backward``).
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "discogan."

NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records the range ``discogan.<name>`` while a
    profiler runs, and does nothing otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return NULL
