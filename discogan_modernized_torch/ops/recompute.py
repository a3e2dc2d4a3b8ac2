"""What a rematerialized forward tells the ops (train/graph.py's checkpoint
regions, ``torch.utils.checkpoint`` without reentry).

A region's first forward runs as usual; in the backward, the region runs
its forward once more to rebuild the tensors it did not keep. Two things
must not happen twice:

- the train-mode BatchNorm advances its running statistics and its count
  inside the forward (ops/batchnorm.py): ``batchnorm_train`` leaves them
  alone while ``recomputing()``;
- under the "conv" policy every convolution's output is kept and never
  computed again: each convolution (the kernels' ``_Conv`` and
  ``_HeadConvT``, the decoder's convTs and the latent products in
  ops/autograd.py) records its outputs in the region's ``Stash`` on the
  first forward and hands them back in order on the second, so only the
  BatchNorm and activation chains between them run again.

K1's and K3's statistics sum in a fixed order, so the rebuilt
normalization equals the first one bit for bit.
"""

from __future__ import annotations

import threading

_local = threading.local()


class Stash:
    """The convolution outputs of one region, in the order they ran."""

    def __init__(self):
        self.outputs: list = []
        self.next = 0


class _Mode:
    def __init__(self, recomputing: bool, stash: Stash | None):
        self.recomputing, self.stash = recomputing, stash

    def __enter__(self):
        self.outer = getattr(_local, "mode", None)
        if self.recomputing and self.stash is not None:
            self.stash.next = 0
        _local.mode = self
        return self

    def __exit__(self, *exc):
        _local.mode = self.outer
        return False


def contexts(keep_convs: bool):
    """The (forward, recompute) context managers of one region, the
    ``context_fn`` of ``torch.utils.checkpoint.checkpoint``; with
    ``keep_convs`` the region keeps its convolutions' outputs."""
    stash = Stash() if keep_convs else None
    return _Mode(False, stash), _Mode(True, stash)


def recomputing() -> bool:
    """Whether a region is rebuilding its forward in the backward."""
    mode = getattr(_local, "mode", None)
    return mode is not None and mode.recomputing


def replay():
    """A convolution's recorded outputs when its region replays them, else
    None (compute them)."""
    mode = getattr(_local, "mode", None)
    if mode is None or not mode.recomputing or mode.stash is None:
        return None
    out = mode.stash.outputs[mode.stash.next]
    mode.stash.next += 1
    return tuple(t.detach() for t in out) if isinstance(out, tuple) else out.detach()


def record(out):
    """Keep a convolution's outputs (a tensor or a tuple of them) where its
    region keeps them; returns ``out``."""
    mode = getattr(_local, "mode", None)
    if mode is not None and not mode.recomputing and mode.stash is not None:
        mode.stash.outputs.append(
            tuple(t.detach() for t in out) if isinstance(out, tuple) else out.detach())
    return out
