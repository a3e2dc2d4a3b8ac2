"""The BatchNorm kernels against the library path on the card (the port of
the JAX package's ``tools/kernel_bench.py``).

At the generator's activation shapes at 64px batch 64 and 512px batch 32
(the JAX tool's), bf16, it times the train-mode BatchNorm with LeakyReLU
two ways: the kernels, K1 (``batch_stats``) then K2
(``fused_batchnorm_act``), and the library, ``F.batch_norm`` on the batch
statistics then ``F.leaky_relu``; and the statistics alone, K1 against
``torch.var_mean``. Each kernel path is held against its plain version
first. Times are medians of CUDA-event timed calls, L2 evicted before
each and after a device sleep long enough for the host to issue the
path's launches (K2's folding of gamma and beta is a few small ops;
tools/timing.py); GB/s count x read and y written once, the least
the function moves, which the bound is of (3.35 TB/s).

    python -m discogan_modernized_torch.tools.kernel_bench
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

# (N, H, W, C): generator activation shapes at 64px b64 and 512px b32.
SHAPES = [(64, 32, 32, 64), (64, 8, 8, 256), (32, 256, 256, 64), (32, 32, 32, 1024)]
TOL = 2e-2  # bf16: the kernel and the plain version round at other places


def bench(shape, timer, device) -> dict:
    from ..ops.fused import (batch_stats, batch_stats_plain, bn_act_plain,
                             fused_batchnorm_act)
    from ..ops.batchnorm import fold_bn
    from .timing import HBM_BYTES_PER_S

    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(shape, generator=g, device=device).bfloat16()
    c = shape[-1]
    gamma, beta = torch.ones(c, device=device), torch.zeros(c, device=device)
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor (channels-last)

    def kernel():
        mean, var = batch_stats(x)
        return fused_batchnorm_act(x, mean, var, gamma, beta, act="leaky_relu")

    def library():
        y = F.batch_norm(xc, None, None, gamma, beta, training=True, eps=1e-5)
        return F.leaky_relu(y, 0.2)

    mean, var = batch_stats_plain(x)
    want = bn_act_plain(x, *fold_bn(gamma, beta, mean, var), "leaky_relu").float()
    got = kernel().float()
    err = float((got - want).abs().max())
    if err > TOL * max(1.0, float(want.abs().max())):
        raise AssertionError(f"kernel_bench {shape}: K1 + K2 off the plain version by {err}")
    m, v = batch_stats(x)
    if float((m - mean).abs().max()) > 1e-4 or float((v - var).abs().max()) > 1e-4:
        raise AssertionError(f"kernel_bench {shape}: K1 off the plain statistics")
    t_lib = timer.ms(library) / 1e3
    t_ker = timer.ms(kernel) / 1e3
    t_stats = timer.ms(lambda: batch_stats(x)) / 1e3
    t_var_mean = timer.ms(lambda: torch.var_mean(xc, dim=(0, 2, 3), correction=0)) / 1e3
    bytes_rw = x.numel() * 2 * 2  # read + write bf16
    return {"shape": list(shape), "library_us": t_lib * 1e6, "kernel_us": t_ker * 1e6,
            "library_GB_s": bytes_rw / t_lib / 1e9, "kernel_GB_s": bytes_rw / t_ker / 1e9,
            "bound_us": bytes_rw / HBM_BYTES_PER_S * 1e6, "ratio": t_lib / t_ker,
            "stats_kernel_us": t_stats * 1e6, "stats_var_mean_us": t_var_mean * 1e6,
            "max_abs_err": err}


def main(argv=None) -> list:
    from .timing import LAYER_SLEEP_CYCLES, Timer, require_card, smi_line

    device = require_card("kernel_bench")
    print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    timer = Timer(sleep_cycles=LAYER_SLEEP_CYCLES)
    rows = []
    for shape in SHAPES:
        r = bench(shape, timer, device)
        rows.append(r)
        print(f"{str(shape):24s} library {r['library_us']:8.1f} us "
              f"({r['library_GB_s']:6.1f} GB/s)   kernel {r['kernel_us']:8.1f} us "
              f"({r['ratio']:4.2f}x; bound {r['bound_us']:.1f} us)   statistics: K1 "
              f"{r['stats_kernel_us']:.1f} us, var_mean {r['stats_var_mean_us']:.1f} us",
              flush=True)
    print(json.dumps({"kernel_bench": rows}))
    return rows


if __name__ == "__main__":
    main()
