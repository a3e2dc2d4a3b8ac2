"""Per-mode memory of one rank of the train step (the port of the JAX
package's ``tools/memory_report.py``).

For each mode (``single``: one process; ``dp``: ``--n_devices`` data
ranks; ``gspmd``: tensor parallelism on a (data, model) mesh with ``--tp``
model ranks; ``spatial``: the same mesh cut into bands of rows) and each
rank, the bytes it holds:

  param_bytes       the four networks' parameters, exact: whole, or this
                    rank's slice where parallel/gspmd.py::shard_spec
                    splits one over the model axis (tensor parallelism);
  opt_bytes         both Adam states' moments, the same way, in the slim
                    mode's storage type;
  batch_bytes       the two domains' images of the rank's rows (f32);
  activation_bytes  the port's memory model of one step
                    (train/step.py::estimate_step_bytes) less its part
                    that does not grow with the batch, at the rank's
                    batch; under spatial sharding a band's share of it;
  live_bytes        their sum.

Every rank of a mode holds the same (the mesh splits evenly), so each mode
gives one rank's dict and the count of ranks. With ``--device cuda`` (the
default) it also trains one step of ``--which`` in one process on the
card and gives its peak (``torch.cuda.max_memory_allocated``) beside the
model's estimate of it. The JAX tool read XLA's plan of the compiled
program on virtual CPU devices; the port runs eagerly, so the parameter
and state bytes are counted and the activations modelled; ``--device
cpu`` gives those without the card.

    python -m discogan_modernized_torch.tools.memory_report \\
        --image_size 512 --batch 8 --modes single,dp,gspmd,spatial [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

MODES = ("single", "dp", "gspmd", "spatial")


def _split(numel: int, dim, tp: int) -> int:
    return numel // tp if dim is not None else numel


def state_bytes(image_size: int, tp: int, slim_state: str | None, model_arch="discogan"):
    """(param bytes, optimizer bytes) one rank holds at model axis ``tp``
    (1: whole). The networks are built on the meta device: shapes only."""
    from ..models.discriminator import Discriminator
    from ..models.generator import Generator
    from ..parallel.gspmd import shard_spec
    from ..train.graph import trainable_subsets
    from ..train.step import TrainConfig, resolve_slim_state

    slim = resolve_slim_state(TrainConfig(image_size=image_size, slim_state=slim_state))
    with torch.device("meta"):
        nets = {"gen_A": Generator(image_size), "gen_B": Generator(image_size),
                "dis_A": Discriminator(image_size), "dis_B": Discriminator(image_size)}
    p_item = 2 if slim == "all" else 4
    m_item = 4 if slim == "off" else 2
    params = opt = 0
    trained = {k for keys in trainable_subsets(model_arch) for k in keys}
    for name, net in nets.items():
        for pname, p in net.named_parameters():
            n = _split(p.numel(), shard_spec(net, pname, tp), tp)
            params += n * p_item
            if name in trained:
                opt += 2 * n * m_item
    return params, opt


def activation_bytes(image_size: int, batch: int, itemsize: int, slim: str) -> int:
    """The memory model's bytes that grow with the batch, at ``batch``."""
    from ..train.step import estimate_step_bytes

    if batch <= 0:
        return 0
    return (estimate_step_bytes(image_size, batch, itemsize, slim)
            - estimate_step_bytes(image_size, 0, itemsize, slim))


def analyze(image_size: int, batch: int, modes, n_devices: int = 8, tp: int = 2,
            which: str = "gen", slim_state: str | None = None, itemsize: int = 2) -> dict:
    """{"image_size", "global_batch", "n_devices", "tp", "which",
    "slim_state", "modes": {mode: one rank's bytes}}; ``batch`` is the
    global batch."""
    from ..train.step import TrainConfig, resolve_slim_state

    slim = resolve_slim_state(TrainConfig(image_size=image_size, slim_state=slim_state))
    report = {"image_size": image_size, "global_batch": batch, "n_devices": n_devices,
              "tp": tp, "which": which, "slim_state": slim_state or "off", "modes": {}}
    img = image_size * image_size * 3 * 4
    for mode in modes:
        if mode not in MODES:
            raise SystemExit(f"unknown mode {mode!r}")
        if mode != "single" and n_devices % (tp if mode != "dp" else 1):
            raise SystemExit(f"--tp {tp} does not divide --n_devices {n_devices}")
        ranks = 1 if mode == "single" else n_devices
        data_ranks = ranks if mode in ("single", "dp") else ranks // tp
        model = tp if mode == "gspmd" else 1
        if batch % data_ranks:
            raise SystemExit(f"batch {batch} does not split over {data_ranks} data ranks")
        local = batch // data_ranks
        params, opt = state_bytes(image_size, model, slim_state)
        act = activation_bytes(image_size, local, itemsize, slim)
        if mode == "spatial":  # a band of rows: 1/tp of each map
            act //= tp
        entry = {"ranks": ranks, "data_ranks": data_ranks, "model_ranks": ranks // data_ranks,
                 "rank_batch": local, "param_bytes": params, "opt_bytes": opt,
                 "batch_bytes": 2 * local * img, "activation_bytes": act}
        entry["live_bytes"] = sum(entry[k] for k in ("param_bytes", "opt_bytes",
                                                      "batch_bytes", "activation_bytes"))
        report["modes"][mode] = entry
    return report


def measured_peak(image_size: int, batch: int, which: str, slim_state, device) -> dict:
    """One step of ``which`` in one process on the card from a seeded state:
    its peak allocated bytes beside the memory model's estimate."""
    from ..core.precision import BF16, configure
    from ..train.step import (TrainConfig, estimate_step_bytes, init_train_state,
                              make_train_steps, resolve_slim_state)

    configure(BF16)
    cfg = TrainConfig(image_size=image_size, precision="bf16", slim_state=slim_state,
                      remat=False)
    ts = init_train_state(0, cfg, device)
    g = torch.Generator(device=device).manual_seed(0)
    A, B = (torch.rand(batch, image_size, image_size, 3, generator=g, device=device)
            for _ in range(2))
    gen_step, dis_step = make_train_steps(cfg, BF16)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    (gen_step if which == "gen" else dis_step)(ts, A, B, 0.01)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    model = estimate_step_bytes(image_size, batch, 2, resolve_slim_state(cfg))
    del ts, A, B
    torch.cuda.empty_cache()
    return {"measured_peak_bytes": peak, "model_bytes": model, "model_over_measured":
            model / peak}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image_size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8, help="GLOBAL batch size")
    ap.add_argument("--modes", type=str, default="single,dp,gspmd,spatial")
    ap.add_argument("--n_devices", type=int, default=8)
    ap.add_argument("--tp", type=int, default=2, help="model-axis size for gspmd/spatial")
    ap.add_argument("--which", type=str, default="gen", choices=["gen", "dis"])
    ap.add_argument("--slim_state", type=str, default=None, choices=["off", "mv", "all"])
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda: also measure the single mode's peak on the card; cpu: the "
                         "counts and the model alone")
    args = ap.parse_args(argv)
    from ..core.device import resolve_device

    device = resolve_device(args.device)
    report = analyze(args.image_size, args.batch,
                     [m.strip() for m in args.modes.split(",") if m.strip()],
                     n_devices=args.n_devices, tp=args.tp, which=args.which,
                     slim_state=args.slim_state)
    if device.type == "cuda":
        from .timing import smi_line

        report["card"] = smi_line()
        report["single_measured"] = measured_peak(args.image_size, args.batch, args.which,
                                                  args.slim_state, device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
