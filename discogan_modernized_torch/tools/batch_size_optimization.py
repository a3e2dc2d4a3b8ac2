"""Batch-size auto-tuner (ref batch_size_optimization.py; the port of the
JAX package's ``tools/batch_size_optimization.py``).

The reference binary-searches the batch size by instantiating 2 generators
and 2 discriminators, running the forward-only loss graph (AB/BA/ABA/BAB
and 4 D forwards, ref :46-101) and reading nvidia-smi's free memory. Here
each candidate builds the train state on the card and runs that forward
graph (``graph.discogan_losses``), or with ``--train_step`` one D and one G
step, and a ``torch.cuda.OutOfMemoryError`` rejects it; after a rejected
probe its tensors are freed and ``torch.cuda.empty_cache()`` returns the
cache. The probe's optimizer state is the trainers' default slim state
(``--slim_state``, bf16 moments), as the printed commands run it, and the
json names it. ``--target_memory`` is held against the probe's memory after it
ran, as the JAX tool's ``bytes_in_use`` (``torch.cuda.memory_allocated``)
over the card's total (``torch.cuda.mem_get_info``); the probe's peak
(``torch.cuda.max_memory_allocated``) is recorded beside it. Results go to
batch_size_results.json with the safety margin and example commands (ref
:147-205). ``--device cpu`` probes on the CPU, where only a failure to
allocate ends the search.

    python -m discogan_modernized_torch.tools.batch_size_optimization \\
        --image_size 512 --train_step
"""

from __future__ import annotations

import argparse
import gc
import json
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="GPU 메모리에 최적화된 배치 크기 찾기")
    parser.add_argument("--device", type=str, default="cuda",
                        help="사용할 디바이스 (cuda, cuda:N 또는 cpu)")
    parser.add_argument("--gpu", type=int, default=None,
                        help="참조 구현 호환 플래그 (--device cuda:N 과 동일)")
    parser.add_argument("--model_arch", type=str, default="discogan",
                        choices=["discogan", "recongan", "gan"])
    parser.add_argument("--image_size", type=int, default=64)
    parser.add_argument("--min_batch", type=int, default=16)
    parser.add_argument("--max_batch", type=int, default=512)
    parser.add_argument("--step", type=int, default=16)
    parser.add_argument("--target_memory", type=float, default=0.85,
                        help="목표 메모리 사용률 (0.0-1.0)")
    parser.add_argument("--extra_layers", action="store_true",
                        help="참조 구현 호환용 (아키텍처 동일)")
    parser.add_argument("--safety_margin", type=float, default=0.9,
                        help="결과 배치 크기에 적용할 안전 마진")
    parser.add_argument("--train_step", action="store_true",
                        help="순전파 대신 전체 학습 스텝으로 측정 (더 정확)")
    parser.add_argument("--output", type=str, default="batch_size_results.json")
    return parser.parse_args(argv)


def trainer_slim_state() -> str:
    """The trainers' default ``--slim_state``: the optimizer state a
    probe holds."""
    from ..cli.common import translation_parser

    return translation_parser().get_default("slim_state")


class Probe:
    """Candidates of one search: the train state is made once, on the
    device, and every candidate runs on it (its bytes do not depend on
    the batch)."""

    def __init__(self, image_size: int, model_arch: str, device, train_step: bool):
        from ..core.precision import configure, default_policy
        from ..train.step import TrainConfig, init_train_state

        self.device, self.train_step, self.image_size = device, train_step, image_size
        self.policy = default_policy(None, device)
        configure(self.policy)
        # model_arch changes what the probe allocates (the gan arch trains
        # only the gen_B/dis_B subset), and the optimizer's state is the
        # trainer's default slim state: the recommendation must measure
        # the graph and state that its example commands run.
        self.cfg = TrainConfig(image_size=image_size, model_arch=model_arch,
                               slim_state=trainer_slim_state())
        self.ts = init_train_state(0, self.cfg, device)

    def __call__(self, batch_size: int):
        """(ok, memory utilization or None, peak utilization or None)."""
        from ..train.graph import discogan_losses
        from ..train.step import make_train_steps

        cuda = self.device.type == "cuda"
        gc.collect()  # what a rejected probe left
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        rng = np.random.RandomState(0)
        shape = (batch_size, self.image_size, self.image_size, 3)
        try:
            A = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(self.device)
            B = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(self.device)
            if self.train_step:
                gen_step, dis_step = make_train_steps(self.cfg, self.policy)
                losses = dis_step(self.ts, A, B, 0.01)
                losses = gen_step(self.ts, A, B, 0.01)
            else:
                for m in self.ts.models.values():
                    m.requires_grad_(False)
                with torch.no_grad():
                    losses = discogan_losses(self.ts.models, A, B, policy=self.policy)
            ok = all(np.isfinite(float(v)) for v in losses.values())
            if not cuda:
                return ok, None, None
            torch.cuda.synchronize(self.device)
            total = torch.cuda.mem_get_info(self.device)[1]
            return (ok, torch.cuda.memory_allocated(self.device) / total,
                    torch.cuda.max_memory_allocated(self.device) / total)
        except (torch.cuda.OutOfMemoryError, MemoryError):
            return False, None, None
        finally:
            A = B = losses = None  # noqa: F841 -- free the probe's tensors
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()


def find_optimal_batch_size(args, probe=None) -> dict:
    """Step-quantized binary search (ref :103-166)."""
    from ..core.device import resolve_device

    if probe is None:
        probe = Probe(args.image_size, args.model_arch, resolve_device(args.device),
                      args.train_step)
    lo = args.min_batch // args.step
    hi = args.max_batch // args.step
    best = 0
    best_util = None
    history = []
    while lo <= hi:
        mid = (lo + hi) // 2
        bs = mid * args.step
        if bs == 0:
            lo = mid + 1
            continue
        print(f"배치 크기 {bs} 테스트 중...", flush=True)
        ok, util, peak = probe(bs)
        over_target = util is not None and util > args.target_memory
        history.append({"batch_size": bs, "ok": bool(ok), "memory_utilization": util,
                        "peak_utilization": peak})
        if ok and not over_target:
            best = bs
            best_util = util
            lo = mid + 1
        else:
            hi = mid - 1

    recommended = max(args.step,
                      int(best * args.safety_margin) // args.step * args.step) \
        if best else 0
    return {
        "model_arch": args.model_arch,
        "image_size": args.image_size,
        "max_working_batch_size": best,
        "memory_utilization": best_util,
        "safety_margin": args.safety_margin,
        "recommended_batch_size": recommended,
        "history": history,
    }


def main(argv=None):
    args = parse_args(argv)
    if args.gpu is not None:
        args.device = f"cuda:{args.gpu}"
    result = find_optimal_batch_size(args)
    out = Path(args.output)
    out.write_text(json.dumps(dict(result, slim_state=trainer_slim_state()), indent=2))
    print(f"\n결과 저장: {out}")
    bs = result["recommended_batch_size"]
    if bs:
        print("\n===== 권장 배치 크기 =====")
        print(f"최대 작동 배치: {result['max_working_batch_size']}")
        print(f"권장 배치 (마진 적용): {bs}")
        print("\n예시 명령:")
        print(f"  python -m discogan_modernized_torch.cli.image_translation "
              f"--task_name=edges2shoes --model_arch={args.model_arch} "
              f"--image_size={args.image_size} --batch_size={bs}")
        print(f"  python -m discogan_modernized_torch.cli.distributed_image_translation "
              f"--distributed --task_name=tops2hanbok --image_size=512 --batch_size={bs}")
    else:
        print("작동하는 배치 크기를 찾지 못했습니다.")
    return result


if __name__ == "__main__":
    main()
