"""The halving conv's kernels against cuDNN on the card (the port of the
JAX package's ``tools/conv_kernel_bench.py``).

    python -m discogan_modernized_torch.tools.conv_kernel_bench
        [--size 64] [--batch 64] [--dw] [--dx] [--fused] [--dtype bf16]

Per k4/s2/p1 layer of the encoder at ``--size`` and ``--batch``: K3
(``conv2d_k4s2p1``) against ``F.conv2d``, held against it first (3e-2 of
max(1, max|ref|), the JAX tool's guard); the stem too, which K3 takes on
its own route (the JAX tool skipped it: no Pallas kernel took 3 channels).
Where the generator's route takes the layer to K5f (``takes_halo``: enc1 at
>= 256px), K5f (``halo_conv2d_k4s2p1``) too, held against ``F.conv2d``
first, in ``halo_kernel_us`` and ``halo_ratio`` beside K3's row at the same
shape: one run's K3-against-K5f A/B in the dtype asked for.
``--dw`` adds the weight gradient, K4 (``conv2d_k4s2p1_dw``) against
``torch.nn.grad.conv2d_weight``, and K5b (``halo_conv2d_k4s2p1_dw``) where
the generator's route takes the layer to K5f (enc1 at >= 256px), each
beside its bound (``dw_bound_us``, ``dw_bound_by``: the larger of its
flops over the dtype's peak and its bytes, x, dy and dw once each, over
the memory rate) and its share of it (``dw_kernel_share``,
``dw_halo_share``);
``--fused`` the train form with its BatchNorm and LeakyReLU, K3 with its
statistics then K2, against cuDNN, ``F.batch_norm`` and ``F.leaky_relu``;
``--dx`` cuDNN's input gradient alone (the port has no dx kernel but the
stem's, K6). Times are medians of CUDA-event timed calls, L2 evicted
before each and after a device sleep long enough for the host to issue a
train form's launches (tools/timing.py); TF/s over the layer's 2 x MACs.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad

GUARD = 3e-2


def _layers(image_size: int, batch: int):
    from ..models.geometry import encoder_channels

    chans = encoder_channels(image_size)
    size, cin = image_size, 3
    out = []
    for c in chans:
        out.append((batch, size, cin, c))
        size, cin = size // 2, c
    return out


def _check(what, got, want):
    err = float((got.float() - want.float()).abs().max())
    ref = float(want.float().abs().max())
    if err > GUARD * max(ref, 1.0):
        raise AssertionError(f"conv_kernel_bench {what}: {err} off the library's ({ref})")


def bench_layer(n, s, ci, co, dtype, timer, device, *, dw=False, dx=False, fused=False) -> dict:
    from ..ops.batchnorm import fold_bn
    from ..ops.conv_k4s2p1 import conv2d_k4s2p1, conv2d_k4s2p1_dw
    from ..ops.fused import bn_act
    from ..ops.halo_conv import halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_dw, takes_halo
    from .timing import bound_ms

    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(n, s, s, ci, generator=g, device=device).to(dtype)
    w = (torch.randn(4, 4, ci, co, generator=g, device=device) * 0.05).to(dtype)
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    flops = 2 * n * (s // 2) ** 2 * co * ci * 16

    def lib_conv():
        return F.conv2d(xc, wc, stride=2, padding=1)

    def ker_conv():
        return conv2d_k4s2p1(x, w)

    _check(f"{s}px {ci}->{co} fwd", ker_conv(), lib_conv().permute(0, 2, 3, 1))
    t_lib, t_ker = timer.ms(lib_conv) / 1e3, timer.ms(ker_conv) / 1e3
    row = {"layer": f"{s}px {ci}->{co}", "library_us": t_lib * 1e6, "kernel_us": t_ker * 1e6,
           "library_tf": flops / t_lib / 1e12, "kernel_tf": flops / t_ker / 1e12,
           "ratio": t_lib / t_ker}
    if takes_halo(x, w):
        def halo_conv():
            return halo_conv2d_k4s2p1(x, w)

        _check(f"{s}px {ci}->{co} halo fwd", halo_conv(), lib_conv().permute(0, 2, 3, 1))
        t_halo = timer.ms(halo_conv) / 1e3
        row.update(halo_kernel_us=t_halo * 1e6, halo_tf=flops / t_halo / 1e12,
                   halo_ratio=t_lib / t_halo)
    if fused and co >= 64:
        gamma = torch.rand(co, generator=g, device=device)
        beta = torch.randn(co, generator=g, device=device)

        def lib_fused():
            y = F.batch_norm(lib_conv(), None, None, gamma, beta, training=True, eps=1e-5)
            return F.leaky_relu(y, 0.2)

        def ker_fused():
            y, (mean, mean_sq) = conv2d_k4s2p1(x, w, with_stats=True)
            var = torch.clamp_min(mean_sq - mean.square(), 0.0)
            return bn_act(y, *fold_bn(gamma, beta, mean, var), "leaky")

        _check(f"{s}px {ci}->{co} fused", ker_fused(), lib_fused().permute(0, 2, 3, 1))
        row["fused_library_us"] = timer.ms(lib_fused) * 1e3
        row["fused_kernel_us"] = timer.ms(ker_fused) * 1e3
        row["fused_ratio"] = row["fused_library_us"] / row["fused_kernel_us"]
    if dx or dw:
        dy = torch.randn(n, s // 2, s // 2, co, generator=g, device=device).to(dtype)
        dyc = dy.permute(0, 3, 1, 2)
    if dx:
        t_dx = timer.ms(lambda: nn_grad.conv2d_input(xc.shape, wc, dyc, stride=2,
                                                     padding=1)) / 1e3
        row["dx_library_us"], row["dx_library_tf"] = t_dx * 1e6, flops / t_dx / 1e12
    if dw:
        def lib_dw():
            return nn_grad.conv2d_weight(xc, wc.shape, dyc, stride=2, padding=1)

        want = lib_dw().permute(2, 3, 1, 0)
        _check(f"{s}px {ci}->{co} dw", conv2d_k4s2p1_dw(x, dy), want)
        bound, by = bound_ms(flops, (x.numel() + dy.numel() + w.numel()) * x.element_size(),
                             dtype)
        row["dw_library_us"] = timer.ms(lib_dw) * 1e3
        row["dw_kernel_us"] = timer.ms(lambda: conv2d_k4s2p1_dw(x, dy)) * 1e3
        row["dw_ratio"] = row["dw_library_us"] / row["dw_kernel_us"]
        row.update(dw_bound_us=bound * 1e3, dw_bound_by=by,
                   dw_kernel_share=bound * 1e3 / row["dw_kernel_us"])
        if takes_halo(x, w):
            _check(f"{s}px {ci}->{co} halo dw", halo_conv2d_k4s2p1_dw(x, dy), want)
            row["dw_halo_kernel_us"] = timer.ms(lambda: halo_conv2d_k4s2p1_dw(x, dy)) * 1e3
            row["dw_halo_ratio"] = row["dw_library_us"] / row["dw_halo_kernel_us"]
            row["dw_halo_share"] = bound * 1e3 / row["dw_halo_kernel_us"]
    return row


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dw", action="store_true")
    ap.add_argument("--dx", action="store_true",
                    help="time cuDNN's input gradient (no dx kernel but the stem's)")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "f32"])
    args = ap.parse_args(argv)

    from ..core.precision import BF16, F32, configure
    from .timing import LAYER_SLEEP_CYCLES, Timer, require_card, smi_line

    device = require_card("conv_kernel_bench")
    policy = BF16 if args.dtype == "bf16" else F32
    configure(policy)
    print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    timer = Timer(sleep_cycles=LAYER_SLEEP_CYCLES)
    rows = []
    for n, s, ci, co in _layers(args.size, args.batch):
        row = bench_layer(n, s, ci, co, policy.compute_dtype, timer, device, dw=args.dw,
                          dx=args.dx, fused=args.fused)
        rows.append(row)
        print(json.dumps(row), flush=True)
    wins = [r["layer"] for r in rows if r["ratio"] > 1.05]
    print(json.dumps({"summary": "kernel_wins", "layers": wins}))
    return rows


if __name__ == "__main__":
    main()
