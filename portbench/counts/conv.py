"""Frozen count of the convolution work of one DiscoGAN train step: every
conv and convT of the loss graph in forward, input gradient (dx) and weight
gradient (dw), by the step's multiplicities, without recomputation. It is
the analytic count of the program's ``tools/roofline.py`` and
``tools/step_itemize.py`` (their per-layer shapes, ``layer_flops``,
``layer_io_bytes``, ``MULTIPLICITIES``), copied so that the yardstick does
not move with the program.

A layer op's flops are 2 * multiply-adds over its output pixels (a conv) or
its input pixels (a convT), and its dx and dw take as many. Its bytes read
each operand once and write the result once, in the compute dtype.
"""

from __future__ import annotations

import math

LATENT = 100

# (forwards, dx instances, dw instances, dx instances of the first layer
# where they differ), by network, for each step kind. G step: 4 generator
# forwards with dw everywhere and dx everywhere but the first layer of the
# two first-stage forwards; the discriminators' 2 fake forwards take dx
# only. The lean D step: 2 generator forwards without backward; dw on every
# discriminator layer of its 4 forwards, dx on all but the first. The full
# D step also runs the generators' two reconstruction forwards.
MULTIPLICITIES = {
    "gen": {"gen": (4, 4, 4, 2), "dis": (4, 2, 0, None)},
    "lean": {"gen": (2, 0, 0, None), "dis": (4, 4, 4, 0)},
    "dis": {"gen": (4, 0, 0, None), "dis": (4, 4, 4, 0)},
}


def channels(image_size: int) -> list[int]:
    n = int(math.log2(image_size)) - 2
    return [min(64 * 2 ** i, 2048) for i in range(n)]


def gen_layers(image_size: int) -> list:
    """(name, op, in_size, cin, cout) of one generator forward's convs."""
    chans = channels(image_size)
    rows, size, cin = [], image_size, 3
    for i, c in enumerate(chans):
        rows.append((f"enc{i}", "conv", size, cin, c))
        size, cin = size // 2, c
    rows.append(("latent", "latent", size, cin, LATENT))
    rev = chans[::-1]
    rows.append(("dec0", "latent_t", 1, LATENT, rev[0]))
    size, cin = image_size // 2 ** len(chans), rev[0]
    for i, c in enumerate(rev[1:], 1):
        rows.append((f"dec{i}", "convt", size, cin, c))
        size, cin = size * 2, c
    rows.append(("head", "head", size, cin, 3))
    return rows


def dis_layers(image_size: int) -> list:
    chans = channels(image_size)
    rows, size, cin = [], image_size, 3
    for i, c in enumerate(chans):
        rows.append((f"dis{i}", "conv", size, cin, c))
        size, cin = size // 2, c
    rows.append(("dis_head", "latent", size, cin, 1))
    return rows


def out_size(op: str, size: int) -> int:
    return {"conv": size // 2, "latent": 1, "latent_t": 4}.get(op, 2 * size)


def layer_flops(op: str, size: int, cin: int, cout: int, batch: int) -> int:
    pixels = out_size(op, size) ** 2 if op in ("conv", "latent") else size ** 2
    return 2 * batch * pixels * cin * cout * 16


def layer_bytes(op: str, size: int, cin: int, cout: int, batch: int, itemsize: int) -> int:
    """One mode's operand bytes (fwd, dx and dw alike): x, w and y once."""
    x = batch * size * size * cin
    y = batch * out_size(op, size) ** 2 * cout
    w = (size * size if op == "latent" else 16) * cin * cout
    return (x + w + y) * itemsize


def step_ops(image_size: int, batch: int, itemsize: int, kind: str) -> list:
    """(flops, bytes) of each conv op instance of one step of ``kind``
    ("gen", "dis", "lean")."""
    out = []
    for rows, net in ((gen_layers(image_size), "gen"), (dis_layers(image_size), "dis")):
        fwd_n, dx_n, dw_n, first_dx_n = MULTIPLICITIES[kind][net]
        for i, (_, op, size, cin, cout) in enumerate(rows):
            dxn = first_dx_n if i == 0 and first_dx_n is not None else dx_n
            f = layer_flops(op, size, cin, cout, batch)
            b = layer_bytes(op, size, cin, cout, batch, itemsize)
            out += [(f, b)] * (fwd_n + dxn + dw_n)
    return out


def step_flops(image_size: int, batch: int, kind: str) -> int:
    return sum(f for f, _ in step_ops(image_size, batch, 2, kind))


def step_least_seconds(image_size: int, batch: int, itemsize: int, kind: str,
                       peak_flops: float, peak_bytes_per_s: float) -> float:
    """The least time the chip could take for the step's conv work: each
    op's larger of flops over the peak rate and bytes over the bandwidth,
    summed."""
    return sum(max(f / peak_flops, b / peak_bytes_per_s)
               for f, b in step_ops(image_size, batch, itemsize, kind))
