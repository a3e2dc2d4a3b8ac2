"""Flag parsing for the port's entry points: the inference CLI's flags
(ref inference.py:12-37) and the two trainers' (ref image_translation.py
:21-81, angle_pairing.py:22-72), with the JAX package's extensions that
are ported, and the optional ``--config`` YAML of flag defaults. Flags of
features not ported yet are left out, so argparse refuses them
(``trainer_parser`` lists them).

The port runs on the card by default (``--device cuda``) and raises when
there is none; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse


def parse_with_config(parser: argparse.ArgumentParser, argv=None):
    """Parse args with optional --config YAML defaults (CLI flags win).

    Config values go through the same ``type`` conversion and ``choices``
    checks a command-line string would, and unknown keys are refused."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    known, _ = pre.parse_known_args(argv)
    parser.add_argument("--config", type=str, default=None,
                        help="YAML file of flag defaults (CLI flags override)")
    if known.config:
        import yaml

        with open(known.config) as f:
            conf = yaml.safe_load(f) or {}
        actions = {a.dest: a for a in parser._actions}
        unknown = set(conf) - set(actions)
        if unknown:
            raise SystemExit(f"unknown config keys: {sorted(unknown)}")
        checked = {}
        for key, val in conf.items():
            a = actions[key]
            if a.type is not None and isinstance(val, str):
                try:
                    val = a.type(val)
                except (TypeError, ValueError):
                    raise SystemExit(
                        f"config key {key!r}: invalid value {val!r} "
                        f"(expected {getattr(a.type, '__name__', a.type)})")
            elif a.type in (int, float) and val is not None:
                if isinstance(val, bool) or not isinstance(val, (int, float)):
                    raise SystemExit(
                        f"config key {key!r}: invalid value {val!r} "
                        f"(expected {a.type.__name__})")
                coerced = a.type(val)
                if coerced != val:
                    raise SystemExit(
                        f"config key {key!r}: value {val!r} is not a valid "
                        f"{a.type.__name__} (lossy conversion)")
                val = coerced
            if a.choices is not None and val is not None \
                    and val not in a.choices:
                raise SystemExit(
                    f"config key {key!r}: invalid choice {val!r} "
                    f"(choose from {sorted(map(str, a.choices))})")
            checked[key] = val
        parser.set_defaults(**checked)
    return parser.parse_args(argv)


def inference_parser() -> argparse.ArgumentParser:
    """inference.py flags (ref :12-37)."""
    p = argparse.ArgumentParser(description='DiscoGAN inference (PyTorch/CUDA)')
    p.add_argument('--device', type=str, default='cuda',
                   help='Device to use (cuda/cpu); cuda raises when no card '
                        'is available')
    p.add_argument('--model_path', type=str, default=None,
                   help='Directory with gen_A_final.pth / gen_B_final.pth '
                        '(required unless --exported is given)')
    p.add_argument('--exported', type=str, default=None,
                   help='(extension) run from a torch.export artifact '
                        '(tools/export_model.py, .pt2) instead of a checkpoint: '
                        'the weights are inside; it must match --image_size, '
                        'and --batch_size unless its batch is symbolic')
    p.add_argument('--exported_rev', type=str, default=None,
                   help='(extension) the reverse generator\'s artifact, for the '
                        'reconstruction panel')
    p.add_argument('--input_path', type=str, required=True,
                   help='Path to input image or directory with images')
    p.add_argument('--output_dir', type=str, default='./inference_results',
                   help='Directory to save the inference results')
    p.add_argument('--image_size', type=int, default=64,
                   help='Image size')
    p.add_argument('--direction', type=str, default='AtoB',
                   choices=['AtoB', 'BtoA'],
                   help='Translation direction: AtoB or BtoA')
    p.add_argument('--use_extra_layers', action='store_true',
                   help='Kept for reference compatibility: the reference '
                        'Generator\'s extra_layers branches are functionally '
                        'identical (model.py:77-212), so this is accepted '
                        'and ignored')
    p.add_argument('--precision', type=str, default=None,
                   choices=['bf16', 'f32'],
                   help='(extension) compute precision; default bf16 on '
                        'CUDA, f32 on the CPU')
    p.add_argument('--dataset_type', type=str, default=None,
                   choices=['edges2handbags', 'edges2shoes', 'handbags2shoes',
                            'celebA', None],
                   help='Dataset type for domain-specific preprocessing')
    p.add_argument('--domain', type=str, default=None, choices=['A', 'B', None],
                   help='Domain for preprocessing (A: edge/sketch, B: real image)')
    p.add_argument('--batch_size', type=int, default=1,
                   help='(extension) batch directory inputs through the '
                        'generator for throughput; 1 = reference behavior')
    return p


def trainer_parser(description: str, *, task_default: str, epochs_default: int,
                   starting_rate_default: float, default_rate_default: float,
                   image_save_default: int,
                   celebA_flags: bool) -> argparse.ArgumentParser:
    """The flags both trainers take (the JAX package's ``add_common_flags``,
    ``cli/common.py:81-235``), as far as the port has them; the data
    parallel trainer's own flags are ``distributed_parser``'s. Refused:
    --xla_copts, which sets XLA flags and has no CUDA meaning, and
    --ckpt_backend, since the port writes its train state with torch.save
    only (the JAX package's orbax backend has no counterpart here)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument('--device', type=str, default='cuda',
                   help='Device to use (cuda/cpu); cuda raises when no card '
                        'is available')
    p.add_argument('--task_name', type=str, default=task_default,
                   help='Set data name (facescrub/celebA/edges2shoes/'
                        'edges2handbags/handbags2shoes/shoes2handbags/'
                        'tops2hanbok/hanbok2tops/car2car/face2face/'
                        'chair2chair/chair2car/chair2face/car2face, or '
                        'synthetic); datasets sit under '
                        'DISCOGAN_DATASETS_ROOT (default ./datasets)')
    p.add_argument('--results_dir', type=str, default='./results/',
                   help='Directory to save the results')
    p.add_argument('--models_dir', type=str, default='./models/',
                   help='Directory to save models')
    p.add_argument('--model_arch', type=str, default='discogan',
                   help='Model architecture: gan/recongan/discogan')
    p.add_argument('--epochs', type=int, default=epochs_default,
                   help='Number of epochs to train')
    p.add_argument('--batch_size', type=int, default=64, help='Batch size')
    p.add_argument('--learning_rate', type=float, default=0.0002,
                   help='Learning rate for optimizer')
    p.add_argument('--beta1', type=float, default=0.5,
                   help='Beta1 for Adam optimizer')
    p.add_argument('--beta2', type=float, default=0.999,
                   help='Beta2 for Adam optimizer')
    p.add_argument('--image_size', type=int, default=64, help='Image size')
    p.add_argument('--gan_curriculum', type=int, default=10000,
                   help='Number of steps with strong GAN loss')
    p.add_argument('--starting_rate', type=float, default=starting_rate_default,
                   help='Initial lambda weight between GAN and Recon loss')
    p.add_argument('--default_rate', type=float, default=default_rate_default,
                   help='Lambda weight between GAN and Recon loss after '
                        'curriculum')
    if celebA_flags:
        p.add_argument('--style_A', type=str, default=None,
                       help='Style A for CelebA (e.g., Male, Young)')
        p.add_argument('--style_B', type=str, default=None,
                       help='Style B for CelebA')
        p.add_argument('--constraint', type=str, default=None,
                       help='Constraint for CelebA')
        p.add_argument('--constraint_type', type=str, default=None,
                       help='Constraint type (1/-1) for CelebA')
    p.add_argument('--n_test', type=int, default=200,
                   help='Number of test images')
    p.add_argument('--update_interval', type=int, default=3,
                   help='Interval for discriminator updates')
    p.add_argument('--log_interval', type=int, default=50,
                   help='Print loss interval')
    p.add_argument('--image_save_interval', type=int, default=image_save_default,
                   help='Image save interval')
    p.add_argument('--model_save_interval', type=int, default=10000,
                   help='Model save interval')
    p.add_argument('--precision', type=str, default=None,
                   choices=['bf16', 'f32'],
                   help='(extension) compute precision; default bf16 on '
                        'CUDA, f32 on the CPU')
    p.add_argument('--bn_sync', action='store_true',
                   help='(extension) cross-rank BatchNorm statistics under data '
                        'parallelism (default: per rank, as DDP keeps them)')
    p.add_argument('--seed', type=int, default=1234,
                   help='(extension) init and shuffle seed (the reference '
                        'distributed trainer hardcodes torch.manual_seed(1234))')
    p.add_argument('--slim_state', type=str, default='mv',
                   choices=['off', 'mv', 'all'],
                   help='(extension) optimizer state: mv = Adam moments in '
                        'bf16 (update math f32; the trainer default), off = '
                        'f32 moments, all = moments and master parameters '
                        'in bf16, the parameters written back with '
                        'stochastic rounding')
    p.add_argument('--resume', type=str, default=None,
                   help='(extension) model dir with a full train state '
                        '(train_state.pt): resumes the networks, the '
                        'optimizer state and the iteration count exactly, '
                        'and trains on to the run\'s original total')
    p.add_argument('--debug', action='store_true',
                   help='(extension) autograd anomaly detection: a NaN in '
                        'the backward raises with the forward op that made it')
    p.add_argument('--paired', action='store_true',
                   help='(extension) run each A-side/B-side pair of network '
                        'forwards as one pass on a pair axis: one kernel '
                        'launch a layer for both networks, the same weight '
                        'trajectory bit for bit')
    p.add_argument('--lean_dis', action='store_true',
                   help='(extension) skip the ABA/BAB reconstruction '
                        'forwards on discriminator iterations that are not '
                        'logged. The weight trajectory is the same bit for '
                        'bit (train-mode BatchNorm uses batch statistics); '
                        'only the generators\' running statistics take fewer '
                        'updates. Logged iterations run the full graph, so '
                        'training_log.txt is exact.')
    p.add_argument('--remat', type=str, default=None, choices=['on', 'off'],
                   help='(extension) rematerialize the network forwards in '
                        'the backward (the same bits, less memory, more '
                        'work); default auto: on where the step\'s estimated '
                        'peak exceeds the card\'s free memory (one line says '
                        'why), off on the CPU')
    p.add_argument('--remat_policy', type=str, default=None,
                   choices=['full', 'latent', 'conv'],
                   help='(extension) remat granularity: full = keep only '
                        'each network\'s input and output, latent = also the '
                        'generators\' 1x1 latents, conv = every conv output '
                        '(the backward rebuilds only the BatchNorm and '
                        'activation chains)')
    p.add_argument('--steps_per_call', type=int, default=None,
                   help='(extension) train iterations a call, gathered from '
                        'the decoded dataset on the device, each step kind '
                        'replayed as a CUDA graph on the card. Default: with '
                        'the dataset on the card, 24 at <= 128px, 6 (two '
                        'D/G periods) above without remat, 1 with remat on '
                        'there; 1 otherwise. 1 = one step a call. Above 1 '
                        'it needs the dataset on the device (on the CPU it '
                        'is built for it, and the steps run eagerly)')
    p.add_argument('--no_device_cache', action='store_true',
                   help='(extension) keep the decoded dataset off the '
                        'device: batches come from the host loader, one '
                        'step a call. Otherwise the dataset goes on the card '
                        'where both domains fit 30%% of its memory')
    p.add_argument('--profile', type=str, default=None, metavar='DIR',
                   help='(extension) write a torch.profiler Chrome trace of '
                        'iterations 2-9 (CUDA and CPU on the card) into DIR')
    return p


def translation_parser() -> argparse.ArgumentParser:
    """image_translation.py flags (ref :21-81)."""
    return trainer_parser('DiscoGAN trainer (PyTorch/CUDA)',
                          task_default='facescrub', epochs_default=100,
                          starting_rate_default=0.01, default_rate_default=0.5,
                          image_save_default=1000, celebA_flags=True)


def distributed_parser() -> argparse.ArgumentParser:
    """distributed_image_translation.py flags (ref :48-126; the JAX
    package's ``cli/common.py:246-290``)."""
    p = translation_parser()
    p.description = 'DiscoGAN data-parallel trainer (PyTorch/CUDA)'
    p.add_argument('--distributed', action='store_true',
                   help='Data-parallel training, one process a rank '
                        '(torch.distributed: NCCL on the card, gloo on the CPU). '
                        'Under torchrun the ranks come from its environment; '
                        'else this starts --world_size local processes')
    p.add_argument('--multihost', action='store_true',
                   help='Ranks on several hosts: joins the process group at '
                        '--coordinator_address as rank --process_id of '
                        '--num_processes (needs --distributed)')
    p.add_argument('--coordinator_address', type=str, default=None,
                   help='(multihost) host:port of the rendezvous')
    p.add_argument('--num_processes', type=int, default=None,
                   help='(multihost) the number of processes')
    p.add_argument('--process_id', type=int, default=None,
                   help='(multihost) this process\'s rank')
    p.add_argument('--local_rank', type=int, default=0,
                   help='The card of this process on its host (LOCAL_RANK '
                        'in the environment sets it and forces --distributed)')
    p.add_argument('--world_size', type=int, default=None,
                   help='Ranks to start without torchrun (default: the '
                        'visible cards; 1 on the CPU)')
    p.add_argument('--parallel_mode', type=str, default='dp',
                   choices=['dp', 'gspmd', 'spatial'],
                   help='(extension) dp = data parallelism; gspmd = data x '
                        'tensor parallelism (wide conv weights split by output '
                        'channel over the model axis); spatial = data x '
                        'spatial (image rows split over the model axis); '
                        'BatchNorm global on either mesh')
    p.add_argument('--tp', type=int, default=None,
                   help='(extension) model-axis size of gspmd/spatial (default: '
                        '2 on an even world larger than 1, else 1; must divide '
                        'the world)')
    p.add_argument('--load_gen_A', type=str, default=None,
                   help='Path to a gen_A checkpoint (.pth) to start from')
    p.add_argument('--load_gen_B', type=str, default=None,
                   help='Path to a gen_B checkpoint (.pth) to start from')
    p.add_argument('--load_dis_A', type=str, default=None,
                   help='Path to a dis_A checkpoint (.pth) to start from')
    p.add_argument('--load_dis_B', type=str, default=None,
                   help='Path to a dis_B checkpoint (.pth) to start from')
    return p


def angle_parser() -> argparse.ArgumentParser:
    """angle_pairing.py flags (ref :22-72)."""
    return trainer_parser('DiscoGAN for angle pairing (PyTorch/CUDA)',
                          task_default='car2car', epochs_default=10,
                          starting_rate_default=0.9, default_rate_default=0.9,
                          image_save_default=500, celebA_flags=False)
