"""The alternating G/D update (the port of the JAX package's
``train/step.py``).

The reference builds both loss graphs every iteration and backwards one
(ref image_translation.py:384-390: D on iters % update_interval == 0, G
otherwise). Here each step runs the full forward graph once, all eight
logged loss components come out of either step, and builds gradients only
for the networks its optimizer updates, as ``jax.value_and_grad`` over the
trainable subset does: the other networks' parameters do not require
grad, so a D step keeps no graph through the generators, and a G step
keeps the discriminators' graph only for their inputs' gradients.

The train state is updated in place: the parameters and the Adam moments,
and the BatchNorm running statistics, which every train-mode forward
advances.

The graph variants of ``TrainConfig`` (train/graph.py) give the same
weight trajectory bit for bit: ``lean_dis`` (``make_lean_dis_step`` on
the D iterations that are not logged), ``remat`` / ``remat_policy`` /
``remat_dis``, ``concat_dis`` and ``paired``. ``resolve_remat`` decides
remat=None from the port's own model of a step's peak memory
(``estimate_step_bytes``) and the card's free memory.

Under data parallelism the steps take ``dp``, a ``parallel.DataParallel``
whose ``bn_sync`` the trainer sets from ``TrainConfig.bn_sync``: the
forward graph then takes it as ``stats_dp`` (cross-rank statistics, carried
in every forward's ops table, so a rematerialized region's rebuild in the
backward takes them too), and
``loss_and_grads`` reduces the gradients over the ranks after
``torch.autograd.grad`` and reports the ranks' mean losses (the JAX
package's ``make_dp_train_steps``). On a (data, model) mesh ``dp`` is a
parallel.gspmd.MeshParallel: the same step, its forwards on the mesh's
shards (ops/sharding.py), BatchNorm global.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.precision import Policy, default_policy
from ..models.discriminator import Discriminator
from ..models.generator import Generator
from ..models.geometry import LATENT_CH, encoder_channels
from ..models.regions import REMAT_POLICIES
from .graph import (_checkpoint_policies, discogan_losses, discogan_losses_paired,
                    mix_losses, trainable_subsets)
from .optim import Adam


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    image_size: int = 64
    model_arch: str = "discogan"
    learning_rate: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    weight_decay: float = 1e-5
    gan_curriculum: int = 10000
    starting_rate: float = 0.01
    default_rate: float = 0.5
    update_interval: int = 3
    skip_first_fm: bool = False  # the angle trainer's variant (ref angle_pairing.py:114-115)
    precision: str | None = None
    # Optimizer state: None/"off" keeps f32 Adam moments; "mv" stores them
    # in bf16 (the update math stays f32); "all" also stores the master
    # parameters in bf16, written back with stochastic rounding
    # (train/optim.py). BatchNorm running statistics stay f32 in every mode.
    slim_state: str | None = None
    # Rematerialize the network forwards in the backward (models/regions.py).
    # None = auto: ``resolve_remat`` turns it on where the step's estimated
    # peak exceeds the card's free memory; off on the CPU.
    remat: bool | None = None
    # Granularity: None/"full", "latent" or "conv" (graph._checkpoint_policies).
    remat_policy: str | None = None
    # Rematerialize the discriminators too (under remat). None = auto: only
    # where the step does not fit with their activations kept.
    remat_dis: bool | None = None
    # Each A-side/B-side pair of forwards as one pass on a pair axis
    # (graph.discogan_losses_paired).
    paired: bool = False
    # Each discriminator's real and fake forwards as one pass (ignored
    # under paired, as in the JAX package).
    concat_dis: bool = False
    # The lean D step on D iterations that are not logged (no ABA/BAB).
    lean_dis: bool = False
    # Logging cadence: logged iterations take the full graph.
    log_interval: int = 50
    # Under data parallelism: cross-rank BatchNorm statistics (and summed
    # gradients) instead of per-rank ones (parallel/dp.py). Without ranks
    # it changes nothing.
    bn_sync: bool = False

    @property
    def use_remat(self) -> bool:
        """Remat as set; an undecided auto (None) is off: the trainer
        decides it first (``resolve_remat``)."""
        return bool(self.remat)

    def use_lean_dis(self, iters: int) -> bool:
        """Whether iteration ``iters`` takes the lean D step: lean_dis is
        on, it is a D iteration, and not a logged one (a logged line needs
        the full graph's recon values)."""
        return (self.lean_dis and self.is_dis_iter(iters)
                and iters % self.log_interval != 0)

    def rate_for(self, iters: int) -> float:
        """Curriculum rate (ref image_translation.py:367)."""
        return self.starting_rate if iters < self.gan_curriculum else self.default_rate

    def is_dis_iter(self, iters: int) -> bool:
        """D trains on iters % update_interval == 0 (ref :385)."""
        return iters % self.update_interval == 0

    def step_kind(self, iters: int) -> str:
        """The step iteration ``iters`` takes: "lean" (the lean D step),
        "dis" or "gen"."""
        return ("lean" if self.use_lean_dis(iters) else
                "dis" if self.is_dis_iter(iters) else "gen")


def resolve_slim_state(cfg: TrainConfig) -> str:
    """"off" | "mv" | "all" (None is "off")."""
    s = cfg.slim_state or "off"
    if s in ("off", "mv", "all"):
        return s
    raise ValueError(f"slim_state must be off, mv or all, got {s!r}")


@dataclasses.dataclass
class TrainState:
    models: dict        # name -> Generator / Discriminator, in train mode
    opt_gen: Adam
    opt_dis: Adam


def init_train_state(seed: int, cfg: TrainConfig,
                     device: torch.device | str = "cpu") -> TrainState:
    """The four networks from one seeded ``torch.Generator`` (gen_A, gen_B,
    dis_A, dis_B in turn), in train mode on ``device``, and the two Adam
    states over the trainable subsets. Under slim state "all" the
    parameters are cast to bf16; the running statistics are not."""
    g = torch.Generator().manual_seed(seed)
    models = {
        "gen_A": Generator(cfg.image_size, generator=g),
        "gen_B": Generator(cfg.image_size, generator=g),
        "dis_A": Discriminator(cfg.image_size, generator=g),
        "dis_B": Discriminator(cfg.image_size, generator=g),
    }
    models = {k: m.to(device).train() for k, m in models.items()}
    if resolve_slim_state(cfg) == "all":
        for m in models.values():
            cast_parameters(m, torch.bfloat16)
    return TrainState(models, *make_optimizers(models, cfg))


def cast_parameters(module, dtype: torch.dtype) -> None:
    """Cast ``module``'s parameters, and not its buffers, to ``dtype``."""
    with torch.no_grad():
        for p in module.parameters():
            p.data = p.data.to(dtype)


def make_optimizers(models: dict, cfg: TrainConfig) -> tuple[Adam, Adam]:
    mv_dtype = (torch.float32 if resolve_slim_state(cfg) == "off"
                else torch.bfloat16)
    return tuple(
        Adam(subset_params(models, keys), lr=cfg.learning_rate,
             beta1=cfg.beta1, beta2=cfg.beta2, weight_decay=cfg.weight_decay,
             mv_dtype=mv_dtype)
        for keys in trainable_subsets(cfg.model_arch))


def subset_params(models: dict, keys) -> list:
    return [p for k in keys for p in models[k].parameters()]


def loss_and_grads(ts: TrainState, A, B, rate, cfg: TrainConfig,
                   policy: Policy, which: str, *, plain: bool = False,
                   lean: bool = False, dp=None):
    """The forward graph of ``cfg``'s variant and the gradients of the
    ``which`` ("gen" or "dis") total over its trainable subset; ``lean``:
    the D step's graph without ABA/BAB. Returns (losses, grads), the losses
    detached (the eight components, gen_total and dis_total). With ``dp``
    (a parallel.DataParallel) the gradients are reduced over its ranks and
    the losses are the ranks' means; the statistics are cross-rank where
    ``dp.bn_sync`` (the trainer makes it from ``cfg.bn_sync``)."""
    gen_keys, dis_keys = trainable_subsets(cfg.model_arch)
    keys = gen_keys if which == "gen" else dis_keys
    for name, m in ts.models.items():
        m.requires_grad_(name in keys)
    graph, extra = ((discogan_losses_paired, {}) if cfg.paired
                    else (discogan_losses, {"concat_dis": cfg.concat_dis}))
    losses = graph(ts.models, A, B, policy=policy, plain=plain,
                   skip_first_fm=cfg.skip_first_fm, remat=cfg.use_remat,
                   remat_policy=cfg.remat_policy, remat_dis=cfg.remat_dis,
                   dis_only=lean and which == "dis",
                   stats_dp=dp if dp is not None and dp.bn_sync else None, **extra)
    gen_total, dis_total = mix_losses(losses, rate, cfg.model_arch)
    total = gen_total if which == "gen" else dis_total
    if dp is not None and dp.bn_sync:  # the rank's share; the ranks' sum is the mean
        total = total / dp.world
    params = subset_params(ts.models, keys)
    grads = torch.autograd.grad(total, params, materialize_grads=True)
    losses = {k: v.detach() for k, v in
              dict(losses, gen_total=gen_total, dis_total=dis_total).items()}
    if dp is not None:
        grads = dp.reduce_grads(which, grads, params)
        losses = dp.mean_losses(losses)
    return losses, grads


def _branch(cfg: TrainConfig, policy: Policy, which: str, lean: bool = False, dp=None):
    _checkpoint_policies(cfg.remat_policy)  # refuse an unknown policy up front

    def step(ts: TrainState, A, B, rate) -> dict:
        losses, grads = loss_and_grads(ts, A, B, rate, cfg, policy, which, lean=lean,
                                       dp=dp)
        (ts.opt_gen if which == "gen" else ts.opt_dis).update(grads)
        return losses
    return step


def make_train_steps(cfg: TrainConfig, policy: Policy | None = None, dp=None):
    """Returns (gen_step, dis_step): (ts, A, B, rate) -> losses, updating ts
    in place. A and B are NHWC images on the models' device: with ``dp``,
    this rank's part of the global batch."""
    policy = policy or default_policy(cfg.precision)
    return _branch(cfg, policy, "gen", dp=dp), _branch(cfg, policy, "dis", dp=dp)


def make_lean_dis_step(cfg: TrainConfig, policy: Policy | None = None, dp=None):
    """The lean D step (cfg.lean_dis): the D update of ``dis_step`` without
    the ABA/BAB forwards, for D iterations that are not logged; its
    recon_A and recon_B report 0 (graph.discogan_losses' dis_only), under
    ``dp`` too (the ranks' mean of zeros)."""
    return _branch(cfg, policy or default_policy(cfg.precision), "dis", lean=True, dp=dp)


# The multi-step driver's planner (the JAX package's train/step.py:388-478
# and the chunk splitting of its train/loop.py:786-799), as pure functions
# with its names and results. The port replays one CUDA graph a step kind
# (train/chunk.py), so a chunk's variant names its shape, not another
# program: "phase" is whole [D, G, ..., G] periods from an aligned
# iteration, "phase_cond" the same with a logged D iteration inside under
# lean_dis, "switch" anything else.
LARGE_IMAGE = 256  # the JAX package's threshold of the large-image regime


def scan_variant(cfg: TrainConfig, it0: int, k: int) -> str:
    """The variant of a chunk of k iterations from it0."""
    ui = cfg.update_interval
    if it0 % ui or k % ui:
        return "switch"
    if cfg.lean_dis and any(i % ui == 0 and i % cfg.log_interval == 0
                            for i in range(it0, it0 + k)):
        return "phase_cond"
    return "phase"


def auto_steps_per_call(cfg: TrainConfig, image_size: int) -> int:
    """The default chunk: about 24 iterations at <= 128px, two whole
    periods from 129px without remat, and 1 (one step a call) with remat
    on there; whole periods always. remat None counts as on from
    LARGE_IMAGE, as in the JAX package; the trainer passes the config
    ``resolve_remat`` decided."""
    ui = cfg.update_interval
    if image_size <= 128:
        return max(ui, (24 // ui) * ui)
    use_remat = (image_size >= LARGE_IMAGE) if cfg.remat is None else cfg.remat
    return 1 if use_remat else 2 * ui


def scan_variants_for_range(cfg: TrainConfig, it0: int, n: int, k: int) -> dict:
    """variant -> first chunk start, over the chunks of size k that cover
    iterations [it0, it0 + n)."""
    out: dict = {}
    for i0 in range(it0, it0 + n, k):
        out.setdefault(scan_variant(cfg, i0, k), i0)
    return out


def chunk_steps(cfg: TrainConfig, iters: int, total: int, steps_per_call: int,
                intervals) -> int:
    """The size of the chunk that starts at ``iters``: at most
    steps_per_call and what is left of ``total``; ending at the next
    iteration that is a multiple of one of ``intervals`` (the sample and
    save intervals: their work follows that iteration); from a misaligned
    iteration, only to the next period's start; else clipped to whole
    periods where it holds one."""
    k = min(steps_per_call, total - iters)
    for iv in intervals:
        k = min(k, -(-iters // iv) * iv - iters + 1)
    ui = cfg.update_interval
    if iters % ui:
        k = min(k, ui - iters % ui)
    elif k >= ui and k % ui:
        k = (k // ui) * ui
    return k


def kinds_in_range(cfg: TrainConfig, it0: int, n: int) -> set:
    """The step kinds of iterations [it0, it0 + n): they repeat with the
    period lcm(update_interval, log_interval)."""
    period = math.lcm(cfg.update_interval, cfg.log_interval)
    return {cfg.step_kind(i) for i in range(it0, it0 + min(n, period))}


# The auto-remat rule's model of one train step's peak device memory, from
# the shapes. What the step holds whatever the batch: parameters, Adam
# moments, one subset's gradients, and each forward's weights written into
# the kernels' layouts where the backward keeps them. What grows with the
# batch: each forward's activations (a conv's output and its
# BatchNorm/activation output a layer, in the compute dtype; the head's
# output in it, in f32 and its sigmoid) where the backward keeps them, what
# a remat region rebuilds at once, and the backward's f32 temporaries at
# the widest layer; ACTIVATION_SHARE of those are alive at the peak, and
# STEP_OVERHEAD_BYTES is what the counts miss. Both fitted by least squares
# to the peaks of the plain 512px step under slim state "mv" at batch 8, 64
# and 128 (12.69, 31.89 and 51.26 GiB; NVIDIA H100 80GB HBM3, 700 W;
# PERF.md), which the model then gives as 13.12, 31.14 and 51.72.
ACTIVATION_SHARE = 0.72
STEP_OVERHEAD_BYTES = 1_276_000_000
# Remat turns on where the estimate exceeds the card's free memory less
# REMAT_MARGIN of it (the allocator's fragmentation, other processes).
REMAT_MARGIN = 0.10


def _param_counts(image_size: int) -> tuple[int, int]:
    """(one generator's, one discriminator's) parameters."""
    chans = encoder_channels(image_size)
    pairs = sum(a * b for a, b in zip(chans[:-1], chans[1:]))
    bn = 2 * sum(chans[1:])
    gen = (16 * (2 * 3 * chans[0] + 2 * pairs + 2 * chans[-1] * LATENT_CH)
           + 2 * bn + 2 * chans[0] + 2 * LATENT_CH)
    dis = 16 * (3 * chans[0] + pairs + chans[-1]) + bn
    return gen, dis


def _map_values(image_size: int) -> list:
    """Values an image of each encoder layer's output (H*W*C)."""
    out, size = [], image_size
    for c in encoder_channels(image_size):
        size //= 2
        out.append(size * size * c)
    return out


def estimate_step_bytes(image_size: int, batch: int, compute_itemsize: int,
                        slim_state: str = "mv", remat: bool = False,
                        remat_policy: str | None = None,
                        remat_dis: bool | None = None) -> int:
    """The model's peak bytes of one G step of the DiscoGAN step (the D
    step keeps less: its generator forwards take no gradient)."""
    gen_p, dis_p = _param_counts(image_size)
    p_bytes = 2 if slim_state == "all" else 4
    m_bytes = 4 if slim_state == "off" else 2
    total_p = 2 * (gen_p + dis_p)
    fixed = total_p * p_bytes + 2 * total_p * m_bytes + 2 * gen_p * p_bytes

    maps = _map_values(image_size)
    img = image_size * image_size * 3
    gen_act = batch * (4 * sum(maps) * compute_itemsize + img * (compute_itemsize + 8))
    dis_act = batch * 2 * sum(maps) * compute_itemsize
    io = batch * img * (compute_itemsize + 4)  # a region's input and output
    g_reg, d_reg = _checkpoint_policies(remat_policy) if remat else (None, None)
    if remat and remat_dis is False:
        d_reg = None
    grows = 3 * batch * max(maps) * 4  # the backward's f32 temporaries
    rebuilt = 0
    for act, casts, region in ((gen_act, gen_p * compute_itemsize, g_reg),
                               (dis_act, dis_p * compute_itemsize, d_reg)):
        # 4 forwards of each network; a region rebuilds one at a time
        if region is None:
            fixed, grows = fixed + 4 * casts, grows + 4 * act
        elif region == "conv":  # the conv outputs kept, the weights cast outside
            fixed, grows = fixed + 4 * casts, grows + 4 * (act // 2 + io)
            rebuilt = max(rebuilt, act // 2)
        else:
            fixed, grows = fixed + casts, grows + 4 * io
            rebuilt = max(rebuilt, act // 2 if region == "latent" else act)
    return int(fixed + ACTIVATION_SHARE * (grows + rebuilt) + STEP_OVERHEAD_BYTES)


def resolve_remat(cfg: TrainConfig, batch: int, device,
                  free_bytes: int | None = None, compute_itemsize: int = 2):
    """(cfg with remat and remat_dis decided, the decision's line). An
    explicit cfg.remat / cfg.remat_dis stands. remat=None turns remat on
    where the step's estimated peak passes ``free_bytes`` (on the card, its
    free memory from ``torch.cuda.mem_get_info``) less REMAT_MARGIN of it,
    and stays off on the CPU; remat_dis=None rematerializes the
    discriminators only where the step does not fit with their activations
    kept.

    The trainer calls it after the dataset is on the card, so the free
    memory is what is left beside it. The chunked path's CUDA graphs hold
    one step's activations in their pool for the run, in place of the
    allocator's cache: the captures share the pool, and no eager step
    follows them. So the same estimate stands for both paths (at 512px
    batch 8 the chunked run peaked 0.06 GiB above the per-step one,
    allocated, and 0.7-0.9 GiB above it reserved, inside REMAT_MARGIN;
    PERF.md)."""
    if cfg.remat_policy is not None and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {cfg.remat_policy!r}")
    device = torch.device(device)
    if free_bytes is None and device.type == "cuda":
        free_bytes = torch.cuda.mem_get_info(device)[0]
    slim = resolve_slim_state(cfg)

    def est(remat, remat_dis=None):
        return estimate_step_bytes(cfg.image_size, batch, compute_itemsize, slim,
                                   remat, cfg.remat_policy, remat_dis)

    budget = None if free_bytes is None else int(free_bytes * (1 - REMAT_MARGIN))
    remat, how = cfg.remat, "set"
    if remat is None:
        remat, how = budget is not None and est(False) > budget, "auto"
    remat_dis = cfg.remat_dis
    if remat and remat_dis is None:
        remat_dis = budget is not None and est(True, False) > budget
    remat_dis = bool(remat and remat_dis)
    gib = 2 ** 30
    line = (f"remat: {'on' if remat else 'off'} ({how}"
            + (", no card" if budget is None else "")
            + f"), policy {cfg.remat_policy or 'full'}, discriminators "
            + f"{'on' if remat_dis else 'off'}; estimated step peak at "
            + f"{cfg.image_size}px batch {batch}: {est(False) / gib:.2f} GiB without "
            + f"remat, {est(True, remat_dis) / gib:.2f} GiB with it"
            + ("" if budget is None else
               f"; {free_bytes / gib:.2f} GiB free, budget {budget / gib:.2f} GiB "
               f"({REMAT_MARGIN:.0%} margin)"))
    return dataclasses.replace(cfg, remat=bool(remat), remat_dis=remat_dis), line


def make_sample_fn(cfg: TrainConfig, policy: Policy | None = None, stats_dp=None):
    """(models, test_A, test_B) -> (AB, BA, ABA, BAB): the reference's
    torch.no_grad() pass with the models left in train mode (ref
    image_translation.py:170-176), so batch statistics normalize and the
    running statistics advance. ``stats_dp``: the forwards' ranks (a
    tensor-parallel mesh's, parallel.gspmd.MeshParallel.for_samples)."""
    policy = policy or default_policy(cfg.precision)

    @torch.no_grad()
    def sample(models: dict, test_A, test_B):
        def g(name, x):
            return models[name](x, policy=policy, stats_dp=stats_dp)

        AB, BA = g("gen_B", test_A), g("gen_A", test_B)
        return AB, BA, g("gen_A", AB), g("gen_B", BA)

    return sample
