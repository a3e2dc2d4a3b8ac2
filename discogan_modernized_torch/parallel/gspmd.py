"""Tensor and spatial sharding on a (data, model) mesh of ranks (the port
of the JAX package's ``parallel/gspmd.py``).

JAX annotates the parameters' and the batch's shardings, jits the plain
step, and XLA's partitioner inserts every collective. The port's kernels
take local tensors, which no sharding propagation can see into, so the
collectives are explicit (ops/sharding.py) and the step is the plain one
(train/step.py ``make_train_steps``) with a ``MeshParallel`` in the place
of the data-parallel ``DataParallel``:

- ``gspmd`` (tensor parallelism): the output-channel axis of every conv and
  convT weight with at least MIN_SHARD_CHANNELS output channels that tp
  divides is split over the model axis (``shard_spec``, JAX
  ``_kernel_spec``), and so are its Adam moments; everything else is
  whole on every rank (the BatchNorm parameters, the 100-channel latent
  conv, the heads). The batch is split over the data axis only.
- ``spatial``: every parameter is whole on every rank; the batch is split
  over the data axis and each image's rows over the model axis (JAX's
  ``P(data, model)`` on NHWC).

BatchNorm is global in both modes, whatever ``--bn_sync`` says (JAX
``gspmd.py:11-15``): the statistics span the whole logical batch, over the
data axis (and in spatial mode over the model axis too, where a map is in
bands). A rank differentiates its data row's share of the loss (its total
over the data axis's size), and the gradients are summed
(``MeshParallel.reduce_grads``): over the data axis where every model rank
computes the whole gradient (a sharded weight's slice, or a parameter of
a layer that runs whole), and over every rank where each model rank holds
a part of it (the BatchNorm parameters of a sharded layer, whose channels
outside this rank's slice get no gradient here; every parameter of a layer
that runs on bands). The logged losses are the data axis's means.

Over a model axis of one rank both modes are data parallelism with global
BatchNorm, and give the bits of the one-process step where the data axis
is one rank too.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from ..core.mesh import Mesh
from ..core.precision import Policy
from ..models.geometry import n_halvings
from ..models.generator import enc_bn_index, enc_conv_index
from ..ops.sharding import splits
from ..train.checkpoint import StateSlices, state_slices
from ..train.graph import trainable_subsets
from ..train.step import (TrainConfig, TrainState, make_lean_dis_step, make_optimizers,
                          make_train_steps)
from .dp import DataParallel, Group, gather

MIN_SHARD_CHANNELS = 256


def shard_spec(net: nn.Module, name: str, tp: int) -> int | None:
    """The axis of parameter ``name`` of ``net`` that tensor parallelism
    splits over a model axis of ``tp`` ranks, or None: the output-channel
    axis of a conv's (O,I,kh,kw) weight (0) or a convT's (I,O,kh,kw) (1)
    with at least MIN_SHARD_CHANNELS output channels that tp divides. The
    matrix products of the latent conv and dec0 read their weights from
    these parameters, so dec0's slice is this rank's channel columns at
    each of the 16 positions."""
    owner_name, _, attr = name.rpartition(".")
    owner = net.get_submodule(owner_name)
    if attr != "weight" or not isinstance(owner, (nn.Conv2d, nn.ConvTranspose2d)):
        return None
    dim = 1 if isinstance(owner, nn.ConvTranspose2d) else 0
    c = owner.weight.shape[dim]
    return dim if c >= MIN_SHARD_CHANNELS and c % tp == 0 else None


def train_state_shardings(models: dict, tp: int) -> dict:
    """network -> parameter name -> ``shard_spec`` (None: whole), for the
    parameters and their Adam moments (JAX ``train_state_shardings``)."""
    return {k: {n: shard_spec(m, n, tp) for n, _ in m.named_parameters()}
            for k, m in models.items()}


def _bn_of(name: str) -> str:
    """The BatchNorm module that follows the conv whose weight is ``name``."""
    if name.startswith("conv"):
        return "bn" + name[len("conv"):].split(".")[0]
    seq, idx, _ = name.split(".")
    return f"{seq}.{int(idx) + 1}"


def banded_layers(image_size: int, tp: int) -> dict:
    """Spatial mode: the modules, by network kind, whose layers run on
    bands (their weights and BatchNorms) at ``image_size`` over ``tp``
    model ranks, by ops/sharding.py's rule ``splits``: the i-th stride-2
    conv's output has image_size >> (i + 1) rows, the j-th convT's input
    2^(j + 1) (dec0's 4x4 map is cut after it; j = n is the head)."""
    n = n_halvings(image_size)
    gen, dis = set(), set()
    for i in range(n):
        if splits(image_size >> (i + 1), tp):
            gen.add(f"encoder.{enc_conv_index(i)}")
            dis.add(f"conv{i + 1}")
            if i:
                gen.add(f"encoder.{enc_bn_index(i)}")
                dis.add(f"bn{i + 1}")
    for j in range(1, n + 1):
        if splits(2 ** (j + 1), tp):
            gen.update({f"decoder.{3 * j}", *([f"decoder.{3 * j + 1}"] if j < n else [])})
    return {"gen": gen, "dis": dis}


class MeshParallel(DataParallel):
    """This rank's place on a (data, model) mesh (core/mesh.py) under
    ``spatial`` or tensor parallelism: the data-parallel ranks of its data
    axis, with BatchNorm global (``bn_sync``) and the world the loss share's
    divisor, plus the model axis's ``tp`` ranks and ``all``, every rank. It
    takes the place of a ``DataParallel`` in the steps (``dp``) and in the
    forwards' ops table (ops/sharding.py). ``place_train_state`` binds it to
    a state: which parameters are split, and which are summed over every
    rank."""

    def __init__(self, mesh: Mesh, spatial: bool = False):
        super().__init__(mesh.data_group, bn_sync=True)
        self.mesh, self.spatial, self.tp = mesh, spatial, mesh.n_model
        self.all = Group(mesh.world_group)
        self.shards: dict = {}        # network -> parameter name -> axis (split ones)
        self._summed_by_all: set = set()  # ids of the parameters summed over every rank

    def bind(self, ts: TrainState, image_size: int, split: dict) -> None:
        """``ts``'s parameters that ``split`` (network -> name -> axis, the
        split ones) splits over the model axis, and which gradients are
        summed over every rank."""
        self._summed_by_all = set()
        self.shards = split
        banded = banded_layers(image_size, self.tp) if self.spatial else {}
        for k, net in ts.models.items():
            partial = ({_bn_of(n) for n in split[k]} if not self.spatial
                       else banded["gen" if k.startswith("gen") else "dis"])
            for n, p in net.named_parameters():
                if n.rpartition(".")[0] in partial:
                    self._summed_by_all.add(id(p))

    def for_samples(self):
        """The ranks the trainer's sample forwards take: under tensor
        parallelism the model axis for the split weights, and BatchNorm over
        the test batch alone, which every rank holds whole (None under
        spatial sharding, whose weights are whole: the plain forward)."""
        if self.spatial or not any(self.shards.values()):
            return None
        local = copy.copy(self)
        local.world = 1
        local.mean = local.rank_mean = lambda t: t
        return local

    @torch.no_grad()
    def reduce_grads(self, subset: str, grads, params=None) -> list:
        """The sum of each gradient over the data axis, or over every rank
        where each model rank holds a part of it; one flat buffer per dtype
        and group of ``subset``'s gradients."""
        grads = list(grads)
        out = [None] * len(grads)
        by_all = [id(p) in self._summed_by_all for p in params]
        for dtype in dict.fromkeys(g.dtype for g in grads):
            for over_all in (False, True):
                idx = [i for i, g in enumerate(grads) if g.dtype == dtype and by_all[i] == over_all]
                if idx:
                    self._reduce((subset, dtype, over_all), grads, idx, out,
                                 self.all.group if over_all else self.group)
        return out


def _piece(t: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    size = t.shape[dim] // parts
    return t.narrow(dim, index * size, size).clone()


def place_train_state(ts: TrainState, mp: MeshParallel, cfg: TrainConfig,
                      device) -> TrainState:
    """A whole train state (the networks and both Adam states, as a
    one-process run holds them; on the CPU) onto this rank of the mesh on
    ``device``: under tensor parallelism each split parameter and its
    moments as this rank's slice, the rest whole. Takes the networks over;
    binds ``mp`` to the new state. The Adam states keep each slice's place
    in its whole tensor (``Adam.shards``), so that the bf16 masters'
    rounding bits are those of the whole tensor's elements."""
    tp, m = mp.tp, mp.mesh.m
    split = {k: {n: d for n, d in specs.items() if d is not None and tp > 1 and not mp.spatial}
             for k, specs in train_state_shardings(ts.models, tp).items()}
    whole_shapes = {}
    with torch.no_grad():
        for k, net in ts.models.items():
            for n, p in net.named_parameters():
                dim = split[k].get(n)
                if dim is not None:
                    whole_shapes[id(p)] = (tuple(p.shape), dim)
                    p.data = _piece(p.data, dim, m, tp)
            net.to(device)
    placed = TrainState(ts.models, *make_optimizers(ts.models, cfg))
    for old, new, keys in zip((ts.opt_gen, ts.opt_dis), (placed.opt_gen, placed.opt_dis),
                              trainable_subsets(cfg.model_arch)):
        new.step = old.step
        with torch.no_grad():
            for i, p in enumerate(new.params):
                shape_dim = whole_shapes.get(id(p))
                for mine, theirs in ((new.m, old.m), (new.v, old.v)):
                    src = theirs[i] if shape_dim is None else _piece(theirs[i], shape_dim[1],
                                                                     m, tp)
                    mine[i].copy_(src)
                if shape_dim is not None:
                    new.shards[i] = (shape_dim[0], shape_dim[1], m * p.shape[shape_dim[1]])
    mp.bind(placed, cfg.image_size, split)
    return placed


@dataclasses.dataclass
class _Moments:
    m: list
    v: list
    step: int


def gather_train_state(ts: TrainState, mp: MeshParallel,
                       moments: bool = True) -> TrainState | None:
    """The whole train state, on the CPU of rank 0, from the slices that
    ``place_train_state`` put on its data row's model ranks: each split
    parameter and its moments gathered one tensor at a time (a collective
    of that row's ranks). The other ranks return None and hold no whole
    tensor; what train/checkpoint.py saves reads the state as it reads a
    one-process one. A state with nothing split is returned as it is, on
    every rank. ``moments`` False: the networks alone (the reference
    layout's), the Adam states None."""
    if not any(mp.shards.values()):
        return ts
    if mp.mesh.d:  # another data row: its slices equal row 0's
        return None
    root = mp.mesh.m == 0

    def whole(t, dim):
        if dim is None:
            return t.detach().to("cpu", copy=True) if root else None
        parts = gather(t.detach(), mp.mesh.model_group)
        return torch.cat(parts, dim) if root else None

    models = {}
    for k, net in ts.models.items():
        memo = {}
        for n, p in net.named_parameters():
            t = whole(p, mp.shards[k].get(n))
            memo[id(p)] = None if t is None else nn.Parameter(t, p.requires_grad)
        if root:
            memo.update((id(b), b.to("cpu", copy=True)) for b in net.buffers())
            models[k] = copy.deepcopy(net, memo)  # the CPU tensors in the module's place
    opts = ([_Moments(*([whole(t, s and s[1]) for t, s in zip(ts_, opt.shards)]
                        for ts_ in (opt.m, opt.v)), opt.step)
             for opt in (ts.opt_gen, ts.opt_dis)] if moments else [None, None])
    return TrainState(models, *opts) if root else None


def local_train_state(ts: TrainState, mp: MeshParallel) -> StateSlices:
    """This rank's slices of a placed state, for the orbax backend's
    collective save (train/checkpoint.py): its parameters (a split one's
    slice, with its axis and whole shape from ``mp.shards``), its buffers,
    both Adam states' ``m`` and ``v`` (a split one's place from
    ``Adam.shards``) and steps; its part is its place on the model axis
    where anything is split (else every tensor is whole, and part 0 is the
    one written), and only data row 0 writes. No collective."""
    sl = state_slices(ts, writes=mp.mesh.d == 0)
    split = any(mp.shards.values())
    if not split:
        sl.writes = sl.writes and mp.mesh.m == 0
        return sl
    sl.part, sl.parts = mp.mesh.m, mp.tp
    for k, net in ts.models.items():
        for n, p in net.named_parameters():
            dim = mp.shards[k].get(n)
            if dim is not None:
                whole = list(p.shape)
                whole[dim] *= mp.tp
                sl.split[f"models/{k}/{n}"] = (dim, tuple(whole))
    for key in ("opt_gen", "opt_dis"):
        opt = getattr(ts, key)
        for i, shard in enumerate(opt.shards):
            if shard is not None:
                for part in ("m", "v"):
                    sl.split[f"{key}/{part}/{i}"] = (shard[1], tuple(shard[0]))
    return sl


def make_gspmd_train_steps(cfg: TrainConfig, mp: MeshParallel,
                           policy: Policy | None = None):
    """(gen_step, dis_step) on the mesh: the plain steps with ``mp`` as
    their ranks (train/step.py). The state is ``place_train_state``'s."""
    return make_train_steps(cfg, policy, mp)


def make_gspmd_lean_dis_step(cfg: TrainConfig, mp: MeshParallel,
                             policy: Policy | None = None):
    """The lean D step (--lean_dis) on the mesh (JAX ``gspmd.py:317-332``)."""
    return make_lean_dis_step(cfg, policy, mp)


def resolve_tp(tp: int | None, world: int) -> int:
    """``--tp``: as set, or 2 on an even world larger than one, else 1 (0
    too takes the default); it must divide the world (JAX
    train/loop.py:305-314)."""
    if not tp or tp <= 0:
        tp = 2 if world % 2 == 0 and world > 1 else 1
    if world % tp:
        raise SystemExit(f"--tp {tp} does not divide the {world}-rank mesh")
    return tp
