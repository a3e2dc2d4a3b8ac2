"""Per-layer forward profile of the generator's encoder on the card (the
port of the JAX package's ``tools/fwd_profile.py``).

Each layer (conv, BatchNorm on the batch statistics and LeakyReLU, as the
port's train forward runs it: K3 with its statistics, or K5f then K1, then
K2; the stem K3 with the activation in its epilogue; the latent's product,
K1 and K2) is timed alone on the card: a median of CUDA-event timed calls,
each after L2 is evicted and a device sleep long enough for the host to
issue the layer's launches (tools/timing.py), where the JAX tool took the
difference of two lengths of a chained scan.

Reports per layer: measured time, conv FLOPs, bytes (input and weights
read, the output written, and read back where BatchNorm must see all of it
first: the JAX tool's count, which read it back at the stem too, where the
activation rides in K3's epilogue), the two
rooflines (989 TFLOP/s bf16 or 67 f32; 3.35 TB/s) and the share of the
binding one achieved.

    python -m discogan_modernized_torch.tools.fwd_profile --image_size=64 --batch=64
"""

from __future__ import annotations

import argparse
import json

import torch


def conv_out(size, k=4, s=2, p=1):
    return (size + 2 * p - k) // s + 1


def layer_table(image_size: int):
    """(name, in_size, in_ch, out_ch, stride, padding, bn) per generator
    encoder layer + latent; decoder mirrors (convT costs ~= mirrored conv)."""
    from ..models.geometry import LATENT_CH, encoder_channels

    chans = encoder_channels(image_size)
    rows = []
    size, cin = image_size, 3
    for i, c in enumerate(chans):
        rows.append((f"enc{i} {size}px {cin}->{c}", size, cin, c, 2, 1, i > 0))
        size = conv_out(size)
        cin = c
    rows.append((f"latent {size}px {cin}->{LATENT_CH}", size, cin, LATENT_CH,
                 1, 0, True))
    return rows


def layer_forward(batch, in_size, cin, cout, stride, bn, dtype, device):
    """A callable of one layer's train forward, on seeded operands."""
    from ..ops.autograd import KERNEL_OPS, batch_stats_fn, conv, mm_fn, train_bn_act
    from ..ops.batchnorm import batchnorm
    from ..ops.sharding import conv_layer

    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(batch, in_size, in_size, cin, generator=g, device=device).to(dtype)
    w = (torch.randn(4, 4, cin, cout, generator=g, device=device)
         * (16 * cin) ** -0.5).to(dtype)
    norm = batchnorm(cout).to(device).train() if bn else None
    ops = KERNEL_OPS

    @torch.no_grad()
    def run():
        if stride == 1:  # the latent: a 4x4 VALID conv is one product
            y = mm_fn(x.reshape(batch, -1), w.reshape(-1, cout)).reshape(batch, 1, 1, cout)
            return train_bn_act(norm, y, *batch_stats_fn(y, ops), "leaky", ops)
        if norm is None:
            return conv(x, w, ops, act="leaky")
        return conv_layer(x, w, norm, "leaky", ops)

    return run


def profile(image_size: int, batch: int, precision=None):
    from ..core.precision import configure, default_policy
    from .timing import HBM_BYTES_PER_S, LAYER_SLEEP_CYCLES, PEAK_FLOPS, Timer, require_card

    device = require_card("fwd_profile")
    policy = default_policy(precision, device)
    configure(policy)
    dtype = policy.compute_dtype
    bpe = dtype.itemsize
    timer = Timer(sleep_cycles=LAYER_SLEEP_CYCLES)
    rows = []
    for name, in_size, cin, cout, stride, padding, bn in layer_table(image_size):
        t = timer.ms(layer_forward(batch, in_size, cin, cout, stride, bn, dtype, device)) / 1e3
        out_size = conv_out(in_size, s=stride, p=padding)
        flops = 2 * batch * out_size * out_size * cout * cin * 16
        bytes_ = bpe * (batch * in_size * in_size * cin      # read x
                        + 16 * cin * cout                    # read w
                        + (2 if bn else 1) * batch * out_size * out_size * cout)  # rw y
        t_flops = flops / PEAK_FLOPS[dtype]
        t_bw = bytes_ / HBM_BYTES_PER_S
        rows.append({
            "layer": name, "ms": t * 1e3, "gflops": flops / 1e9,
            "mbytes": bytes_ / 1e6, "roofline_ms": max(t_flops, t_bw) * 1e3,
            "bound": "compute" if t_flops > t_bw else "bandwidth",
            "efficiency": max(t_flops, t_bw) / t,
        })
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--precision", type=str, default=None)
    args = p.parse_args(argv)

    from .timing import require_card, smi_line

    require_card("fwd_profile")
    print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    rows = profile(args.image_size, args.batch, args.precision)
    total = sum(r["ms"] for r in rows)
    print(f"{'layer':30s} {'ms':>8s} {'roof ms':>8s} {'bound':>9s} "
          f"{'eff':>6s} {'GF':>8s} {'MB':>8s}")
    for r in rows:
        print(f"{r['layer']:30s} {r['ms']:8.3f} {r['roofline_ms']:8.3f} "
              f"{r['bound']:>9s} {r['efficiency']:6.1%} {r['gflops']:8.2f} "
              f"{r['mbytes']:8.1f}")
    print(f"{'TOTAL (encoder+latent)':30s} {total:8.3f} ms")
    print(json.dumps({"image_size": args.image_size, "batch": args.batch, "layers": rows}))
    return rows


if __name__ == "__main__":
    main()
