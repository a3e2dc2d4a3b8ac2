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
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.precision import Policy, default_policy
from ..models.discriminator import Discriminator
from ..models.generator import Generator
from .graph import discogan_losses, mix_losses, trainable_subsets
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

    def rate_for(self, iters: int) -> float:
        """Curriculum rate (ref image_translation.py:367)."""
        return self.starting_rate if iters < self.gan_curriculum else self.default_rate

    def is_dis_iter(self, iters: int) -> bool:
        """D trains on iters % update_interval == 0 (ref :385)."""
        return iters % self.update_interval == 0


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
                   policy: Policy, which: str, *, plain: bool = False):
    """The full forward graph and the gradients of the ``which`` ("gen" or
    "dis") total over its trainable subset. Returns (losses, grads), the
    losses detached (the eight components, gen_total and dis_total)."""
    gen_keys, dis_keys = trainable_subsets(cfg.model_arch)
    keys = gen_keys if which == "gen" else dis_keys
    for name, m in ts.models.items():
        m.requires_grad_(name in keys)
    losses = discogan_losses(ts.models, A, B, policy=policy, plain=plain,
                             skip_first_fm=cfg.skip_first_fm)
    gen_total, dis_total = mix_losses(losses, rate, cfg.model_arch)
    total = gen_total if which == "gen" else dis_total
    grads = torch.autograd.grad(total, subset_params(ts.models, keys),
                                materialize_grads=True)
    losses = dict(losses, gen_total=gen_total, dis_total=dis_total)
    return {k: v.detach() for k, v in losses.items()}, grads


def make_train_steps(cfg: TrainConfig, policy: Policy | None = None):
    """Returns (gen_step, dis_step): (ts, A, B, rate) -> losses, updating ts
    in place. A and B are NHWC images on the models' device."""
    policy = policy or default_policy(cfg.precision)

    def branch(which: str):
        def step(ts: TrainState, A, B, rate) -> dict:
            losses, grads = loss_and_grads(ts, A, B, rate, cfg, policy, which)
            (ts.opt_gen if which == "gen" else ts.opt_dis).update(grads)
            return losses
        return step

    return branch("gen"), branch("dis")


def make_sample_fn(cfg: TrainConfig, policy: Policy | None = None):
    """(models, test_A, test_B) -> (AB, BA, ABA, BAB): the reference's
    torch.no_grad() pass with the models left in train mode (ref
    image_translation.py:170-176), so batch statistics normalize and the
    running statistics advance."""
    policy = policy or default_policy(cfg.precision)

    @torch.no_grad()
    def sample(models: dict, test_A, test_B):
        AB = models["gen_B"](test_A, policy=policy)
        BA = models["gen_A"](test_B, policy=policy)
        return AB, BA, models["gen_A"](AB, policy=policy), models["gen_B"](BA, policy=policy)

    return sample
