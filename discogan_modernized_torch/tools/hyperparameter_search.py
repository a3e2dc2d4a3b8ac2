"""Hyperparameter search orchestrator (ref hyperparameter_search.py; the
port of the JAX package's ``tools/hyperparameter_search.py``).

The reference tool is shipped broken (truncated mid-f-string at :361, and
monitor_process reads an undefined start_time at :244). This is the
complete equivalent with the same trial protocol:

- random sampling over the same 7-parameter space (ref :75-94; grid
  variant :47-73), seeded by ``--seed``;
- one trainer subprocess a trial: the angle tasks through the port's
  ``cli.angle_pairing``, everything else through ``cli.image_translation``
  (ref :131-135);
- per-trial hyperparameters.json / trial_info.json / train.log (ref
  :127-198);
- log polling with early stopping on a non-improving average RECON (ref
  :202-251), on the training_log line contract;
- metric extraction and ranking by avg_recon_loss (ref :253-361).

The slot pool replaces the reference's nvidia-smi free-GPU probe: one
slot a card of ``--gpus`` (or ``--workers`` slots, the visible cards
first). A slot on a card runs its trial with ``CUDA_VISIBLE_DEVICES`` set
to that card; slots beyond the cards pass ``--device cpu`` to the trainer,
so concurrent trials never share a card. Only ``--workers`` makes such
slots: with no card visible and no ``--workers``, the search refuses to
start.

    python -m discogan_modernized_torch.tools.hyperparameter_search \\
        --task_name edges2shoes --trials 20 [--gpus 0,1] [--early_stopping]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import random
import re
import subprocess
import sys
import time
from datetime import datetime
from pathlib import Path

PARAM_RANGES_GRID = {
    "learning_rate": [0.0001, 0.0002, 0.0003, 0.0005],
    "beta1": [0.5, 0.7, 0.9],
    "beta2": [0.9, 0.99, 0.999],
    "starting_rate": [0.01, 0.05, 0.1, 0.2],
    "default_rate": [0.3, 0.5, 0.7, 0.9],
    "gan_curriculum": [5000, 10000, 15000, 20000],
    "update_interval": [1, 2, 3, 5],
}

PARAM_RANGES_RANDOM = {
    "learning_rate": [0.0001, 0.0002, 0.0003, 0.0005, 0.0008],
    "beta1": [0.4, 0.5, 0.6, 0.7, 0.8, 0.9],
    "beta2": [0.9, 0.95, 0.99, 0.999],
    "starting_rate": [0.01, 0.05, 0.1, 0.2, 0.3],
    "default_rate": [0.3, 0.4, 0.5, 0.6, 0.7, 0.9],
    "gan_curriculum": [5000, 8000, 10000, 15000, 20000],
    "update_interval": [1, 2, 3, 5],
}

ANGLE_TASKS = ("car2car", "chair2chair", "face2face")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="DiscoGAN 하이퍼파라미터 탐색")
    parser.add_argument("--task_name", type=str, default="edges2shoes")
    parser.add_argument("--model_arch", type=str, default="discogan")
    parser.add_argument("--workers", type=int, default=None,
                        help="동시 실험 슬롯 수 (카드 수를 넘는 슬롯은 CPU에서 실행)")
    parser.add_argument("--gpus", type=str, default=None,
                        help="참조 구현 호환 플래그: 사용할 GPU ID 목록 (쉼표 구분)")
    parser.add_argument("--trials", type=int, default=20)
    parser.add_argument("--base_epochs", type=int, default=20)
    parser.add_argument("--style_A", type=str, default=None)
    parser.add_argument("--style_B", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default="./hp_search")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--image_size", type=int, default=64)
    parser.add_argument("--early_stopping", action="store_true")
    parser.add_argument("--patience", type=int, default=5)
    parser.add_argument("--poll_interval", type=float, default=30.0,
                        help="로그 폴링 주기 (초)")
    parser.add_argument("--grid", action="store_true",
                        help="무작위 샘플링 대신 그리드 탐색")
    parser.add_argument("--seed", type=int, default=None)
    return parser.parse_args(argv)


def generate_hyperparameters():
    keys = list(PARAM_RANGES_GRID)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*PARAM_RANGES_GRID.values())]


def sample_hyperparameters(num_samples=10):
    return [
        {k: random.choice(v) for k, v in PARAM_RANGES_RANDOM.items()}
        for _ in range(num_samples)
    ]


def trainer_module(task_name: str) -> str:
    return ("discogan_modernized_torch.cli.angle_pairing" if task_name in ANGLE_TASKS
            else "discogan_modernized_torch.cli.image_translation")


def slot_pool(args) -> list:
    """The slots: a card id each (``--gpus``, or the visible cards, at most
    ``--workers``), then None for each slot beyond the cards (the CPU).
    Only ``--workers`` asks for such CPU slots: with no card visible and
    no ``--workers``, this raises."""
    import torch

    cards = ([int(g) for g in args.gpus.split(",") if g.strip()] if args.gpus
             else list(range(torch.cuda.device_count())))
    if args.workers is None and not cards:
        raise RuntimeError("hyperparameter_search: no CUDA card is visible (pass --workers N "
                           "to run N trials at a time on the CPU)")
    n = args.workers if args.workers is not None else len(cards)
    return [cards[i] if i < len(cards) else None for i in range(max(n, 1))]


def trial_command(hp, args, result_dir: Path, card) -> list[str]:
    cmd = [
        sys.executable, "-m", trainer_module(args.task_name),
        f"--task_name={args.task_name}",
        f"--model_arch={args.model_arch}",
        f"--batch_size={args.batch_size}",
        f"--image_size={args.image_size}",
        f"--epochs={args.base_epochs}",
        f"--results_dir={result_dir / 'results'}",
        f"--models_dir={result_dir / 'models'}",
        f"--learning_rate={hp['learning_rate']}",
        f"--beta1={hp['beta1']}",
        f"--beta2={hp['beta2']}",
        f"--starting_rate={hp['starting_rate']}",
        f"--default_rate={hp['default_rate']}",
        f"--gan_curriculum={hp['gan_curriculum']}",
        f"--update_interval={hp['update_interval']}",
    ]
    if args.task_name == "celebA":
        if args.style_A:
            cmd.append(f"--style_A={args.style_A}")
        if args.style_B:
            cmd.append(f"--style_B={args.style_B}")
    if card is None:
        cmd.append("--device=cpu")
    return cmd


def run_trial(hp, args, slot_id, trial_id, card=None):
    """Launch one trial subprocess on ``card`` (None: the CPU). Returns
    (process, result_dir, trial_info)."""
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    result_base = Path(args.output_dir) / args.task_name / args.model_arch
    result_dir = result_base / f"trial_{trial_id}_{timestamp}"
    result_dir.mkdir(parents=True, exist_ok=True)

    with open(result_dir / "hyperparameters.json", "w") as f:
        json.dump(hp, f, indent=2)

    cmd = trial_command(hp, args, result_dir, card)
    env = os.environ.copy()
    if card is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(card)
    # The trainer is this package's module: it must import from here.
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)

    log_file = result_dir / "train.log"
    print(f"시작: 실험 {trial_id}, 슬롯 {slot_id} ({'CPU' if card is None else f'GPU {card}'})")
    print(f"하이퍼파라미터: {hp}")
    print(f"로그: {log_file}")

    with open(log_file, "w") as f:
        process = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env)

    trial_info = {
        "trial_id": trial_id,
        "slot_id": slot_id,
        "device": "cpu" if card is None else f"cuda:{card}",
        "hyperparameters": hp,
        "command": " ".join(cmd),
        "log_file": str(log_file),
        "start_time": timestamp,
        "start_timestamp": time.time(),
        "pid": process.pid,
        "status": "running",
    }
    with open(result_dir / "trial_info.json", "w") as f:
        json.dump(trial_info, f, indent=2)
    return process, result_dir, trial_info


RECON_RE = re.compile(r"RECON: (\d+\.\d+)/(\d+\.\d+)")


def check_early_stop(log_file: Path, state: dict, patience: int) -> bool:
    """Update best-recon tracking from the log; True => terminate trial.
    Only the lines new since the last poll count, each one an observation."""
    if not log_file.exists():
        return False
    matches = RECON_RE.findall(log_file.read_text())
    if not matches:
        return False
    new = matches[state.get("n_seen", 0):]
    if not new:
        return False
    state["n_seen"] = len(matches)
    for a, b in new:
        avg = (float(a) + float(b)) / 2
        if avg < state.get("best", float("inf")):
            state["best"] = avg
            state["no_improvement"] = 0
        else:
            state["no_improvement"] = state.get("no_improvement", 0) + 1
    return state["no_improvement"] >= patience


def _terminate(process):
    process.terminate()
    try:
        process.wait(timeout=30)
    except subprocess.TimeoutExpired:
        process.kill()
        process.wait()


def _finalize_trial(process, result_dir, trial_info, early_stopped=False):
    # A crashed trainer must not compete in the ranking; an early-stopped
    # trial stays rankable under its own label.
    if early_stopped:
        trial_info["status"] = "early_stopped"
    elif process.returncode == 0:
        trial_info["status"] = "completed"
    else:
        trial_info["status"] = "failed"
    trial_info["end_time"] = datetime.now().strftime("%Y%m%d_%H%M%S")
    trial_info["duration"] = time.time() - trial_info["start_timestamp"]
    trial_info["returncode"] = process.returncode
    with open(result_dir / "trial_info.json", "w") as f:
        json.dump(trial_info, f, indent=2)
    print(f"완료: 실험 {trial_info['trial_id']}, 슬롯 {trial_info['slot_id']}"
          f" ({trial_info['status']})")
    return extract_metrics(Path(trial_info["log_file"]))


def monitor_process(process, result_dir, trial_info, args):
    """Poll one trial until exit; early-stop on stagnating RECON."""
    log_file = Path(trial_info["log_file"])
    es_state: dict = {}
    early_stopped = False
    while process.poll() is None:
        time.sleep(args.poll_interval)
        if args.early_stopping and check_early_stop(log_file, es_state, args.patience):
            print(f"조기 종료: 실험 {trial_info['trial_id']}, "
                  f"{args.patience}회 이상 성능 개선 없음")
            _terminate(process)
            early_stopped = True
            break
    process.wait()
    return _finalize_trial(process, result_dir, trial_info, early_stopped=early_stopped)


def extract_metrics(log_file: Path) -> dict:
    """Final GEN/RECON/DIS values from the training_log contract
    (ref :253-292)."""
    metrics = {
        "final_gen_loss_A": None, "final_gen_loss_B": None,
        "final_recon_loss_A": None, "final_recon_loss_B": None,
        "final_dis_loss_A": None, "final_dis_loss_B": None,
    }
    try:
        content = Path(log_file).read_text()
    except OSError:
        return metrics
    for tag, (ka, kb) in (
        ("GEN", ("final_gen_loss_A", "final_gen_loss_B")),
        ("RECON", ("final_recon_loss_A", "final_recon_loss_B")),
        ("DIS", ("final_dis_loss_A", "final_dis_loss_B")),
    ):
        m = re.findall(rf"{tag}: (\d+\.\d+)/(\d+\.\d+)", content)
        if m:
            metrics[ka] = float(m[-1][0])
            metrics[kb] = float(m[-1][1])
    if metrics["final_recon_loss_A"] is not None and metrics["final_recon_loss_B"] is not None:
        metrics["avg_recon_loss"] = (
            metrics["final_recon_loss_A"] + metrics["final_recon_loss_B"]) / 2
    return metrics


def analyze_results(output_dir, task_name, model_arch):
    """Rank completed trials by avg_recon_loss; write analysis.json."""
    result_base = Path(output_dir) / task_name / model_arch
    trial_dirs = [d for d in result_base.glob("trial_*") if d.is_dir()]
    if not trial_dirs:
        print("분석할 실험 결과가 없습니다.")
        return None

    all_trials = []
    for trial_dir in sorted(trial_dirs):
        info_file = trial_dir / "trial_info.json"
        hp_file = trial_dir / "hyperparameters.json"
        if not (info_file.exists() and hp_file.exists()):
            continue
        try:
            trial_info = json.loads(info_file.read_text())
            hp = json.loads(hp_file.read_text())
            metrics = extract_metrics(Path(trial_info["log_file"]))
            all_trials.append({
                "trial_id": trial_info["trial_id"],
                "status": trial_info.get("status", "unknown"),
                "hyperparameters": hp,
                "metrics": metrics,
                "result_dir": str(trial_dir),
            })
        except Exception as e:  # noqa: BLE001
            print(f"실험 {trial_dir} 데이터 로드 오류: {e}")

    completed = [t for t in all_trials
                 if t["status"] in ("completed", "early_stopped")
                 and t["metrics"].get("avg_recon_loss") is not None]
    ranked = sorted(completed, key=lambda t: t["metrics"]["avg_recon_loss"])

    print("\n===== 실험 결과 요약 =====")
    print(f"총 실험 수: {len(all_trials)}")
    print(f"완료된 실험 수: {len(completed)}")
    if ranked:
        best = ranked[0]
        print("\n===== 최적의 하이퍼파라미터 =====")
        print(f"실험 ID: {best['trial_id']}")
        print(f"평균 재구성 손실: {best['metrics']['avg_recon_loss']:.4f}")
        for k, v in best["hyperparameters"].items():
            print(f"  {k}: {v}")

    analysis = {"all_trials": all_trials, "ranking": [t["trial_id"] for t in ranked],
                "best": ranked[0] if ranked else None}
    out = result_base / "analysis.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(analysis, indent=2))
    print(f"분석 저장: {out}")
    return analysis


def main(argv=None):
    args = parse_args(argv)
    if args.seed is not None:
        random.seed(args.seed)
    hps = (generate_hyperparameters() if args.grid
           else sample_hyperparameters(args.trials))[: args.trials]
    cards = slot_pool(args)

    # Poll every running trial each cycle: early stopping fires on any
    # concurrent trial, and a finished slot frees at once.
    free_slots = list(range(len(cards)))
    running: list[dict] = []
    trial_id = 0
    while trial_id < len(hps) or running:
        while trial_id < len(hps) and free_slots:
            slot = free_slots.pop(0)
            proc, rdir, info = run_trial(hps[trial_id], args, slot, trial_id, cards[slot])
            running.append({"proc": proc, "rdir": rdir, "info": info,
                            "slot": slot, "es_state": {}})
            trial_id += 1
        time.sleep(args.poll_interval)
        still = []
        for t in running:
            if t["proc"].poll() is None:
                if args.early_stopping and check_early_stop(
                        Path(t["info"]["log_file"]), t["es_state"], args.patience):
                    print(f"조기 종료: 실험 {t['info']['trial_id']}, "
                          f"{args.patience}회 이상 성능 개선 없음")
                    _terminate(t["proc"])
                    t["early_stopped"] = True
                else:
                    still.append(t)
                    continue
            t["proc"].wait()
            _finalize_trial(t["proc"], t["rdir"], t["info"],
                            early_stopped=t.get("early_stopped", False))
            free_slots.append(t["slot"])
        free_slots.sort()
        running = still

    return analyze_results(args.output_dir, args.task_name, args.model_arch)


if __name__ == "__main__":
    main()
