"""The data-parallel trainer's processes: one process a rank, joined in a
``torch.distributed`` process group (the counterpart of the JAX package's
``core/mesh.py`` and of its trainer's rendezvous, train/loop.py:205-235).

The backend follows the device: NCCL on the card, gloo on the CPU. A run on
the card without NCCL raises. Ranks of one host that outnumber its cards
share them (rank r on card r mod cards), and then talk over gloo, since
NCCL refuses two ranks on one device: what the process finds decides it,
and it prints the choice.

Where the ranks come from, in order:
- torchrun (or any launcher that sets RANK, WORLD_SIZE, LOCAL_RANK,
  MASTER_ADDR and MASTER_PORT): ``env://``;
- ``--multihost``: ``--coordinator_address host:port``, ``--num_processes``
  and ``--process_id``, with the card from ``--local_rank``;
- neither: the distributed CLI starts ``world`` processes on this host
  (``torch.multiprocessing``), each with the launcher's variables set; a
  world of 1 joins a group of its own in this process.

A rank's device is ``cuda:<local rank mod cards>`` on the card. The ranks of one host
(``local_world``: torchrun's LOCAL_WORLD_SIZE; one a process under
``--multihost``, where a process is a host) split that host's batch, as the
devices of a host's mesh split it in the JAX package; the hosts take shards
of the data. Rank 0 is the main process: it alone writes logs, samples and
checkpoints, and its run timestamp is broadcast to every rank so that all
agree on the run's directories.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import torch
import torch.distributed as dist

LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class Ranks:
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str
    local_world: int = 1  # the ranks on this host

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def hosts(self) -> int:
        return self.world // self.local_world

    @property
    def host(self) -> int:
        """This rank's host (launchers number a host's ranks contiguously)."""
        return self.rank // self.local_world

    @property
    def part(self) -> int:
        """This rank's place among its host's ranks: its part of the host's batch."""
        return self.rank % self.local_world


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(device_type: str) -> str:
    """NCCL on the card (raises where it is missing), gloo on the CPU."""
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("data parallelism on the card needs NCCL, which this "
                               "PyTorch build lacks (it does not fall back to gloo)")
        return "nccl"
    return "gloo"


def from_launcher() -> bool:
    """Whether a launcher (torchrun) has set this process's rank."""
    return all(v in os.environ for v in LAUNCHER_VARS)


def init(device_type: str, *, multihost: bool = False, coordinator_address=None,
         num_processes=None, process_id=None, local_rank: int = 0) -> Ranks:
    """Join (or, for a world of one, make) the process group and return
    this process's ranks and device."""
    backend = backend_for(device_type)
    if from_launcher():
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        method = "env://"
    elif multihost:
        if not coordinator_address or num_processes is None or process_id is None:
            raise SystemExit("--multihost needs --coordinator_address, --num_processes "
                             "and --process_id (or a torchrun launch)")
        rank, world, method = process_id, num_processes, f"tcp://{coordinator_address}"
        local_world = 1
    else:
        rank, world, method = 0, 1, f"tcp://localhost:{free_port()}"
        local_world = 1
    if world % local_world:
        raise SystemExit(f"a world of {world} ranks does not split into hosts of "
                         f"{local_world}")
    device = torch.device("cpu")
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        if local_world > cards:
            backend = "gloo"
            print(f"rank {rank}: {local_world} ranks share this host's {cards} card(s); "
                  f"{device} over gloo (NCCL refuses two ranks on one device)")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=method, world_size=world, rank=rank,
                            timeout=TIMEOUT, **kwargs)
    return Ranks(rank, world, local_rank, device, backend, local_world)


def teardown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def broadcast_text(text: str, ranks: Ranks, length: int) -> str:
    """Rank 0's ``text`` (ASCII, ``length`` bytes) on every rank."""
    t = torch.tensor(list(text.encode("ascii").ljust(length)[:length]), dtype=torch.uint8,
                     device=ranks.device)
    dist.broadcast(t, src=0)
    return bytes(t.cpu().tolist()).decode("ascii").rstrip()


def min_over_ranks(values, ranks: Ranks) -> list:
    """The ranks' minimum of each of ``values`` (ints; a collective every
    rank calls), so that every rank takes a decision from the same numbers."""
    t = torch.tensor(list(values), dtype=torch.int64, device=ranks.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return t.tolist()


def any_rank(flag: bool, ranks: Ranks) -> bool:
    """Whether ``flag`` is set on any rank (a collective every rank calls)."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=ranks.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
