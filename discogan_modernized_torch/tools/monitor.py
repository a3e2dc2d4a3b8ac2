"""Card monitor and training job manager (ref gpu_monitor.py; the port of
the JAX package's ``tools/monitor.py``).

The reference's whole failure-detection story: a daemon thread polls
nvidia-smi for temperature, utilization and memory with alert thresholds,
attributes memory to DiscoGAN processes by scraping ps for trainer scripts
and their --task_name, appends text and cumulative JSON telemetry, and with
--auto-restart relaunches a tracked training job that disappears (the same
command line, at most 3 restarts). An interactive menu offers status /
kill / launch / git pull.

Here the card's telemetry comes from nvidia-smi, the reference's own
source (``device_stats``); a trainer's own memory comes from the
``hbm_telemetry.jsonl`` sidecar the port's trainer writes beside its log
(train/loop.py::hbm_sample), since a monitor cannot see another process's
allocator. The trainers are found by the reference's script names and by
the port's module paths; a restart resumes the job from its newest full
train state (``--resume=<dir>``), in its own argv and cwd.

    python -m discogan_modernized_torch.tools.monitor [--auto-restart] [--no-interactive]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
from datetime import datetime
from pathlib import Path

TRAINER_SCRIPTS = (
    "image_translation.py",
    "distributed_image_translation.py",
    "angle_pairing.py",
    "discogan_modernized_torch.cli.image_translation",
    "discogan_modernized_torch.cli.distributed_image_translation",
    "discogan_modernized_torch.cli.angle_pairing",
)
MAX_RESTARTS = 3
SMI_QUERY = ["nvidia-smi",
             "--query-gpu=index,name,temperature.gpu,utilization.gpu,memory.used,"
             "memory.total,power.draw", "--format=csv,noheader,nounits"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="GPU 모니터링 및 작업 관리")
    parser.add_argument("--interval", type=int, default=10,
                        help="모니터링 주기 (초)")
    parser.add_argument("--log_dir", type=str, default="./monitor_logs")
    parser.add_argument("--mem-alert", type=float, default=0.9,
                        help="메모리 사용률 경고 임계값")
    parser.add_argument("--auto-restart", action="store_true",
                        help="사라진 학습 작업 자동 재시작 (최대 3회)")
    parser.add_argument("--stall-polls", type=int, default=3,
                        help="연속 N회 폴링 동안 학습 진행이 없으면 경고")
    parser.add_argument("--no-interactive", action="store_true",
                        help="대화형 메뉴 없이 데몬으로 실행")
    parser.add_argument("--iterations", type=int, default=None,
                        help="(테스트용) 지정 횟수만 폴링 후 종료")
    return parser.parse_args(argv)


def _number(s: str):
    try:
        return float(s)
    except ValueError:  # "[N/A]", "[Not Supported]"
        return None


def device_stats() -> list[dict]:
    """Per card: index, name, temperature (C), utilization (%), memory
    used/total (bytes) and power draw (W), from nvidia-smi (ref
    gpu_monitor.py:41-66); one {"error"} entry where nvidia-smi fails."""
    try:
        out = subprocess.run(SMI_QUERY, capture_output=True, text=True, timeout=30,
                             check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [{"error": str(e)}]
    stats = []
    for line in out.strip().splitlines():
        f = [s.strip() for s in line.split(",")]
        if len(f) < 7:
            continue
        used, total = _number(f[4]), _number(f[5])
        entry = {"id": int(f[0]), "kind": f[1], "platform": "gpu",
                 "temperature_c": _number(f[2]), "gpu_utilization": _number(f[3]),
                 "power_w": _number(f[6])}
        if used is not None and total:
            entry["bytes_in_use"] = int(used * 2 ** 20)
            entry["bytes_limit"] = int(total * 2 ** 20)
            entry["utilization"] = used / total
        stats.append(entry)
    return stats


def host_stats() -> dict:
    """Host RAM + load from /proc (no external tools)."""
    out = {}
    try:
        meminfo = {}
        for line in Path("/proc/meminfo").read_text().splitlines():
            k, v = line.split(":", 1)
            meminfo[k] = int(v.strip().split()[0])
        out["ram_total_kb"] = meminfo.get("MemTotal")
        out["ram_available_kb"] = meminfo.get("MemAvailable")
        if out["ram_total_kb"]:
            out["ram_utilization"] = 1 - out["ram_available_kb"] / out["ram_total_kb"]
        out["loadavg"] = float(Path("/proc/loadavg").read_text().split()[0])
    except Exception as e:  # noqa: BLE001
        out["error"] = str(e)
    return out


def _proc_argv_cwd(pid: int):
    """Exact argv (null-separated, quoting-safe) + cwd from /proc while the
    process is alive: what a faithful relaunch needs; ps output mangles
    quoted/space-containing arguments."""
    try:
        raw = Path(f"/proc/{pid}/cmdline").read_bytes()
        argv = [a for a in raw.decode(errors="replace").split("\0") if a]
        cwd = os.readlink(f"/proc/{pid}/cwd")
        return argv or None, cwd
    except OSError:
        return None, None


def _flag_value(toks, name, default=None):
    for i, t in enumerate(toks):
        if t.startswith(f"--{name}="):
            return t.split("=", 1)[1]
        if t == f"--{name}" and i + 1 < len(toks):
            return toks[i + 1]
    return default


def find_training_jobs() -> list[dict]:
    """DiscoGAN trainer processes by ps cmdline, with --task_name
    attribution (ref gpu_monitor.py:68-117)."""
    jobs = []
    try:
        out = subprocess.check_output(["ps", "-eo", "pid,args"], text=True)
    except Exception:  # noqa: BLE001
        return jobs
    for line in out.splitlines()[1:]:
        line = line.strip()
        if not line or "python" not in line:
            continue
        pid_str, _, cmd = line.partition(" ")
        if not any(s in cmd for s in TRAINER_SCRIPTS):
            continue
        task = _flag_value(cmd.split(), "task_name")
        pid = int(pid_str)
        argv, cwd = _proc_argv_cwd(pid)
        jobs.append({"pid": pid, "cmdline": cmd, "task_name": task,
                     "argv": argv, "cwd": cwd})
    return jobs


def _job_base(argv, cwd, flag: str, default: str) -> Path:
    """<flag dir>/<task>[/<style_A>]/<arch> of a job, against its cwd."""
    base = Path(_flag_value(argv, flag, default))
    if not base.is_absolute() and cwd:
        base = Path(cwd) / base
    base = base / _flag_value(argv, "task_name", "")
    style = _flag_value(argv, "style_A")
    if style:
        base = base / style
    return base / _flag_value(argv, "model_arch", "discogan")


class Monitor:
    def __init__(self, args):
        self.args = args
        self.log_dir = Path(args.log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.text_log = self.log_dir / "monitor.log"
        self.json_log = self.log_dir / "telemetry.json"
        self.history: list[dict] = []
        self.known_jobs: dict[int, dict] = {}
        self.restart_counts: dict[str, int] = {}
        # pid -> (last seen iter, wall time, consecutive stalled polls)
        self.progress: dict[int, tuple[int, float, int]] = {}
        self._log_gap: dict[int, float] = {}  # last observed Iter-line gap
        self._alerted: set[int] = set()  # pids alerted this stall episode
        self.stop_event = threading.Event()

    def log(self, msg: str):
        stamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] {msg}"
        print(line, flush=True)
        with open(self.text_log, "a") as f:
            f.write(line + "\n")

    _ITER_RE = re.compile(r"Iter \[(\d+)/(\d+)\]")

    @staticmethod
    def _job_run_dir(job) -> Path | None:
        """The job's current run directory: the one holding the newest
        training_log.txt under results_dir/task/[style]/arch (against the
        job's cwd). Everything read about a job (iterations, the memory
        sidecar) comes from this run, or a restarted job would be reported
        with a previous run's data."""
        argv = job.get("argv") or job["cmdline"].split()
        base = _job_base(argv, job.get("cwd"), "results_dir", "./results")
        try:
            logs = sorted(base.glob("*/training_log.txt"), key=lambda p: p.stat().st_mtime)
        except OSError:
            return None
        return logs[-1].parent if logs else None

    @staticmethod
    def _tail(path: Path) -> str | None:
        """Last ~4KB of a file, or None."""
        try:
            with open(path, "rb") as f:
                f.seek(max(0, f.seek(0, 2) - 4096))
                return f.read().decode(errors="replace")
        except OSError:
            return None

    def _run_of(self, job) -> Path | None:
        run = job.get("_run_dir")
        return Path(run) if run else self._job_run_dir(job)

    def _job_iters(self, job) -> int | None:
        """Latest iteration from the job's current training_log.txt."""
        run = self._run_of(job)
        tail = self._tail(run / "training_log.txt") if run else None
        if tail is None:
            return None
        ms = self._ITER_RE.findall(tail)
        return int(ms[-1][0]) if ms else None

    def _job_hbm(self, job) -> dict | None:
        """The newest memory record the trainer itself wrote
        (hbm_telemetry.jsonl beside its training_log.txt), from the same
        run as _job_iters."""
        run = self._run_of(job)
        tail = self._tail(run / "hbm_telemetry.jsonl") if run else None
        if not tail:
            return None
        # The 4KB window may open mid-line; scan back to the newest
        # complete JSON record.
        for line in reversed(tail.strip().splitlines()):
            try:
                return json.loads(line)
            except ValueError:
                continue
        return None

    def update_job_progress(self, jobs):
        """Step rate from the jobs' logs, and a stall alert: no new Iter
        line for stall_polls polls and at least 3x the job's last observed
        gap between lines (one alert a stall)."""
        now = time.time()
        for job in jobs:
            pid = job["pid"]
            it = self._job_iters(job)
            if it is None:
                continue
            prev = self.progress.get(pid)
            if prev is not None:
                prev_it, prev_t, stalled = prev
                if it > prev_it and now > prev_t:
                    job["step_rate"] = (it - prev_it) / (now - prev_t)
                    self._log_gap[pid] = now - prev_t
                    self._alerted.discard(pid)
                    stalled = 0
                else:
                    stalled += 1
                    gap_floor = 3.0 * self._log_gap.get(pid, 0.0)
                    if (stalled >= self.args.stall_polls
                            and now - prev_t >= gap_floor
                            and pid not in self._alerted):
                        self._alerted.add(pid)
                        self.log(f"경고: PID {pid} ({job.get('task_name')}) "
                                 f"학습 정체 — {stalled}회 폴링 동안 "
                                 f"iter {it}에서 진행 없음")
                self.progress[pid] = (it, now if it > prev_it else prev_t, stalled)
            else:
                self.progress[pid] = (it, now, 0)
            job["iters"] = it
        live = {j["pid"] for j in jobs}
        for pid in list(self.progress):
            if pid not in live:
                del self.progress[pid]
                self._log_gap.pop(pid, None)
                self._alerted.discard(pid)

    def poll_once(self):
        snap = {
            "time": datetime.now().isoformat(),
            "devices": device_stats(),
            "host": host_stats(),
            "jobs": find_training_jobs(),
        }
        for job in snap["jobs"]:
            run = self._job_run_dir(job)
            if run is not None:
                job["_run_dir"] = str(run)
            hbm = self._job_hbm(job)
            if hbm:
                job["hbm"] = hbm
        self.update_job_progress(snap["jobs"])
        self.history.append(snap)
        del self.history[:-500]
        self.json_log.write_text(json.dumps(self.history, indent=2))

        for d in snap["devices"]:
            util = d.get("utilization")
            if util is not None and util > self.args.mem_alert:
                self.log(f"경고: 디바이스 {d.get('id')} 메모리 사용률 {util:.0%}")
        h = snap["host"]
        if h.get("ram_utilization", 0) > self.args.mem_alert:
            self.log(f"경고: 호스트 RAM 사용률 {h['ram_utilization']:.0%}")

        self.check_and_restart_jobs(snap["jobs"])
        return snap

    def _resume_dir_for(self, argv: list[str], cwd: str | None):
        """The newest full train state (train_state_meta.json) under the
        job's models_dir/task/[style]/arch, against the job's cwd: the
        port's ``--resume`` directory."""
        if any(t == "--resume" or t.startswith("--resume=") for t in argv):
            return None  # already resuming; relaunch as-is
        base = _job_base(argv, cwd, "models_dir", "./models")
        candidates = sorted(base.glob("*/train_state_meta.json"))
        return candidates[-1].parent if candidates else None

    def check_and_restart_jobs(self, jobs):
        """Relaunch tracked jobs that disappeared (ref :212-272), resuming
        from their newest full train state when one exists, with the argv
        and cwd read from /proc while the job was alive; the relaunch's
        output goes to a restart log."""
        current = {j["pid"]: j for j in jobs}
        for pid, job in list(self.known_jobs.items()):
            if pid not in current:
                self.log(f"작업 종료 감지: PID {pid} ({job.get('task_name')})")
                del self.known_jobs[pid]
                if not self.args.auto_restart:
                    continue
                argv = job.get("argv") or job["cmdline"].split()
                cwd = job.get("cwd")
                # The budget's key leaves out our own --resume, so a job
                # that crashes again keeps its count.
                key = "\0".join(a for a in argv if not a.startswith("--resume"))
                n = self.restart_counts.get(key, 0)
                if n >= MAX_RESTARTS:
                    self.log(f"재시작 한도 초과 (>{MAX_RESTARTS}): {job['cmdline'][:80]}")
                    continue
                self.restart_counts[key] = n + 1
                cmd = list(argv)
                try:
                    resume = self._resume_dir_for(argv, cwd)
                except Exception:  # noqa: BLE001
                    resume = None
                if resume is not None:
                    cmd.append(f"--resume={resume}")
                    self.log(f"자동 재시작+복원 ({n + 1}/{MAX_RESTARTS}): --resume={resume}")
                else:
                    self.log(f"자동 재시작 ({n + 1}/{MAX_RESTARTS}): {job['cmdline'][:80]}")
                restart_log = self.log_dir / f"restart_pid{pid}_{n + 1}.log"
                with open(restart_log, "ab") as out:
                    subprocess.Popen(cmd, cwd=cwd, stdout=out, stderr=subprocess.STDOUT)
        for pid, job in current.items():
            if pid not in self.known_jobs:
                self.known_jobs[pid] = job
                self.log(f"작업 추적 시작: PID {pid} ({job.get('task_name')})")

    def run(self):
        n = 0
        while not self.stop_event.is_set():
            self.poll_once()
            n += 1
            if self.args.iterations and n >= self.args.iterations:
                break
            self.stop_event.wait(self.args.interval)


def launch_command(task: str, arch: str) -> list[str]:
    """The menu's new job: the port's trainer module."""
    return [sys.executable, "-m", "discogan_modernized_torch.cli.image_translation",
            f"--task_name={task}", f"--model_arch={arch}"]


def interactive_menu(monitor: Monitor):
    """Status / kill / launch / git pull (ref gpu_monitor.py:282-355)."""
    while True:
        print("\n===== DiscoGAN 모니터 =====")
        print("1. 상태 보기")
        print("2. 작업 종료")
        print("3. 새 작업 시작")
        print("4. git pull")
        print("q. 종료")
        choice = input("> ").strip()
        if choice == "1":
            snap = monitor.poll_once()
            print(json.dumps(snap, indent=2)[:2000])
        elif choice == "2":
            jobs = find_training_jobs()
            for j in jobs:
                print(f"  PID {j['pid']}: {j['task_name']} — {j['cmdline'][:70]}")
            pid = input("종료할 PID: ").strip()
            if pid.isdigit():
                try:
                    os.kill(int(pid), 15)
                    print(f"PID {pid} 종료 요청됨")
                except (ProcessLookupError, PermissionError) as e:
                    print(f"PID {pid} 종료 실패: {e}")
        elif choice == "3":
            task = input("task_name: ").strip() or "edges2shoes"
            arch = input("model_arch [discogan]: ").strip() or "discogan"
            cmd = launch_command(task, arch)
            subprocess.Popen(cmd)
            print(f"시작됨: {' '.join(cmd)}")
        elif choice == "4":
            subprocess.run(["git", "pull"], check=False)
        elif choice == "q":
            monitor.stop_event.set()
            return


def main(argv=None):
    args = parse_args(argv)
    monitor = Monitor(args)
    if args.no_interactive or args.iterations:
        monitor.run()
        return monitor
    t = threading.Thread(target=monitor.run, daemon=True)
    t.start()
    try:
        interactive_menu(monitor)
    except (EOFError, KeyboardInterrupt):
        monitor.stop_event.set()
    return monitor


if __name__ == "__main__":
    main()
