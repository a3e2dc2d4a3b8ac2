"""Data-parallel trainer CLI (ref distributed_image_translation.py), on the
card by default: one process a rank, NCCL between cards, gloo on the CPU
(core/distributed.py, parallel/dp.py), and tensor or spatial sharding on a
mesh of the ranks (parallel/gspmd.py).

    torchrun --nproc_per_node=<cards> -m \\
        discogan_modernized_torch.cli.distributed_image_translation --distributed \\
        --task_name=edges2shoes --image_size=512 --batch_size=16
    python -m discogan_modernized_torch.cli.distributed_image_translation \\
        --distributed --world_size=2 --device=cpu --task_name=synthetic ...
    torchrun --nproc_per_node=4 -m \\
        discogan_modernized_torch.cli.distributed_image_translation --distributed \\
        --parallel_mode=gspmd --tp=2 --task_name=edges2shoes --image_size=512

``--distributed`` turns data parallelism on; LOCAL_RANK in the
environment (torchrun) forces it (ref :617-620). Without a launcher it
starts ``--world_size`` ranks of this command on this host
(``torch.multiprocessing``; default: the visible cards, one on the CPU),
or, for a world of one, trains in this process in a group of its own.
``--multihost`` joins ranks across hosts at ``--coordinator_address`` as
``--process_id`` of ``--num_processes``, one process a host.
``--batch_size`` is one host's batch, as in the JAX package: the host's
ranks each take their rows of it, so W ranks on one host train on the
batches one process takes (train/loop.py). ``--bn_sync`` makes the BatchNorm
statistics the global batch's. The weights-only ``--load_gen_A`` ...
``--load_dis_B`` and the full-state ``--resume`` load on every rank.
``--parallel_mode gspmd`` (tensor parallelism) and ``spatial`` (the
images' rows split) put the ranks on a (data, model) mesh with ``--tp``
ranks on the model axis (default 2 on an even world larger than one, else
1; it must divide the world), BatchNorm global (train/loop.py,
parallel/gspmd.py). Ranks of a host that outnumber its cards share them
over gloo (core/distributed.py).
"""

from __future__ import annotations

import os
import sys

import torch
import torch.multiprocessing as mp

from ..core import distributed
from ..core.device import resolve_device
from ..parallel.gspmd import resolve_tp
from ..train.loop import run_training
from .common import distributed_parser, parse_with_config



def _rank(index: int, argv: list, world: int, port: int) -> None:
    """Rank ``index`` of ``world`` local ranks: the launcher's variables,
    then this CLI."""
    os.environ.update(RANK=str(index), WORLD_SIZE=str(world), LOCAL_RANK=str(index),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    main(argv)


def main(argv=None, *, observer=None):
    """Parse the flags and train; ``observer`` (train/loop.py's) where this
    process trains itself (a world of one, or a rank a launcher started)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_with_config(distributed_parser(), argv)
    if "LOCAL_RANK" in os.environ:
        args.local_rank = int(os.environ["LOCAL_RANK"])
        args.distributed = True
    if args.multihost and not args.distributed:
        raise SystemExit("--multihost requires --distributed: a multi-host run shards "
                         "the global batch over the ranks, which only the distributed "
                         "trainer sets up")
    if not args.distributed:
        return run_training(args, observer=observer)
    device = resolve_device(args.device)
    if not (distributed.from_launcher() or args.multihost):
        world = args.world_size or (torch.cuda.device_count() if device.type == "cuda"
                                    else 1)
        if args.parallel_mode != "dp":
            resolve_tp(args.tp, world)  # refuse a --tp that does not divide before any rank starts
        if world > 1:
            try:
                mp.start_processes(_rank, args=(argv, world, distributed.free_port()),
                                   nprocs=world, start_method="spawn")
            except mp.ProcessException as e:
                raise SystemExit(f"a rank failed: {e}") from e
            return None
    ranks = distributed.init(device.type, multihost=args.multihost,
                             coordinator_address=args.coordinator_address,
                             num_processes=args.num_processes,
                             process_id=args.process_id, local_rank=args.local_rank)
    try:
        return run_training(args, ranks=ranks, observer=observer)
    finally:
        distributed.teardown()


if __name__ == "__main__":
    main()
