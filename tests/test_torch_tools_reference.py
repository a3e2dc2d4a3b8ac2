"""The port's reference tools against the JAX package's, on the CPU: the
hyperparameter search (sampling, log parsing, early stopping, ranking,
trial commands and slots), the batch-size bisection, the monitor (polls
with nvidia-smi's CSV faked, restarts with ``--resume``, the restart cap,
argv and cwd, the stall alert) and the trainer's memory sidecar that the
monitor reads: ``tests/test_tools.py`` and ``test_round2_fixes.py``
re-expressed on the port."""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from discogan_modernized_torch.tools import batch_size_optimization as bso
from discogan_modernized_torch.tools import hyperparameter_search as hps
from discogan_modernized_torch.tools import monitor as mon_mod
from discogan_modernized_tpu.tools import batch_size_optimization as jax_bso
from discogan_modernized_tpu.tools import hyperparameter_search as jax_hps
from discogan_modernized_tpu.tools import monitor as jax_mon
from tests.torch_threads import one_torch_thread  # noqa: F401

HP = {"learning_rate": 2e-4, "beta1": 0.5, "beta2": 0.999, "starting_rate": 0.01,
      "default_rate": 0.5, "gan_curriculum": 10000, "update_interval": 3}
LOG_LINE = ("Iter [{i}/100] GEN: 1.0000/1.0000, FM: 0.1000/0.1000, "
            "RECON: {a}/{b}, DIS: 0.7000/0.7000\n")


# -- hyperparameter search ----------------------------------------------------

def test_hp_spaces_equal_jax():
    assert hps.PARAM_RANGES_GRID == jax_hps.PARAM_RANGES_GRID
    assert hps.PARAM_RANGES_RANDOM == jax_hps.PARAM_RANGES_RANDOM
    assert hps.generate_hyperparameters() == jax_hps.generate_hyperparameters()
    assert len(hps.generate_hyperparameters()) == 4 * 3 * 3 * 4 * 4 * 4 * 4


@pytest.mark.parametrize("seed", [0, 7])
def test_hp_sampling_equals_jax_for_a_seed(seed):
    random.seed(seed)
    want = jax_hps.sample_hyperparameters(10)
    random.seed(seed)
    assert hps.sample_hyperparameters(10) == want


def test_hp_main_samples_as_jax(tmp_path, monkeypatch):
    """main's trials under --seed are JAX main's, in order."""
    seen = {"port": [], "jax": []}
    for mod, key in ((hps, "port"), (jax_hps, "jax")):
        def fake_run_trial(hp, args, slot, trial_id, *rest, key=key):
            seen[key].append(hp)
            d = tmp_path / key / str(trial_id)
            d.mkdir(parents=True)
            (d / "train.log").write_text("")
            proc = SimpleNamespace(poll=lambda: 0, wait=lambda timeout=None: 0,
                                   returncode=0)
            return proc, d, {"trial_id": trial_id, "slot_id": slot,
                             "log_file": str(d / "train.log"),
                             "start_timestamp": time.time()}
        monkeypatch.setattr(mod, "run_trial", fake_run_trial)
        monkeypatch.setattr(mod, "analyze_results", lambda *a, **k: None)
        mod.main(["--trials=5", "--workers=1", "--seed=3", "--poll_interval=0",
                  f"--output_dir={tmp_path}/{key}"])
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 5


def _logs(tmp_path):
    out = []
    for n, vals in enumerate([("0.1222", "0.1181"), ("0.0800", "0.0900")]):
        log = tmp_path / f"log{n}.txt"
        log.write_text("Training started at x\n" + "".join(
            LOG_LINE.format(i=50 * k, a=a, b=b) for k, (a, b) in enumerate([vals] * (n + 1))))
        out.append(log)
    empty = tmp_path / "empty.txt"
    empty.write_text("no lines\n")
    return out + [empty, tmp_path / "missing.txt"]


def test_hp_extract_metrics_equals_jax(tmp_path):
    for log in _logs(tmp_path):
        assert hps.extract_metrics(log) == jax_hps.extract_metrics(log)
    assert hps.extract_metrics(_logs(tmp_path)[1])["avg_recon_loss"] == pytest.approx(0.085)


def _recon_sequence(log, values, check):
    """check_early_stop's answers as RECON lines are appended one by one,
    each polled three times (two of them stale)."""
    state, answers = {}, []
    log.write_text("")
    for i, v in enumerate(values):
        log.write_text(log.read_text() + LOG_LINE.format(i=i, a=v, b=v))
        answers += [check(log, state, 2) for _ in range(3)]
    return answers


@pytest.mark.parametrize("values", [["0.5000", "0.6000", "0.7000"],
                                    ["0.5000", "0.4000", "0.4500", "0.3000", "0.9000"],
                                    ["0.5000"] * 4])
def test_hp_early_stop_equals_jax(tmp_path, values):
    got = _recon_sequence(tmp_path / "a.log", values, hps.check_early_stop)
    want = _recon_sequence(tmp_path / "b.log", values, jax_hps.check_early_stop)
    assert got == want


def test_hp_early_stop_ignores_stale_polls(tmp_path):
    log = tmp_path / "train.log"
    log.write_text(LOG_LINE.format(i=0, a="0.5000", b="0.5000"))
    state: dict = {}
    assert not hps.check_early_stop(log, state, patience=2)
    for _ in range(10):
        assert not hps.check_early_stop(log, state, patience=2)
    for i, v in enumerate(("0.6000", "0.7000")):
        log.write_text(log.read_text() + LOG_LINE.format(i=i + 1, a=v, b=v))
        stop = hps.check_early_stop(log, state, patience=2)
    assert stop


def _trials(base: Path):
    for tid, recon, status in ((0, 0.2, "completed"), (1, 0.1, "completed"),
                               (2, 0.05, "failed"), (3, 0.15, "early_stopped")):
        d = base / f"trial_{tid}_x"
        d.mkdir(parents=True)
        log = d / "train.log"
        log.write_text(LOG_LINE.format(i=0, a=f"{recon:.4f}", b=f"{recon:.4f}"))
        (d / "hyperparameters.json").write_text(json.dumps({"learning_rate": 2e-4}))
        (d / "trial_info.json").write_text(json.dumps({
            "trial_id": tid, "status": status, "log_file": str(log)}))


def test_hp_analyze_results_equals_jax(tmp_path):
    _trials(tmp_path / "edges2shoes" / "discogan")
    got = hps.analyze_results(tmp_path, "edges2shoes", "discogan")
    want = jax_hps.analyze_results(tmp_path, "edges2shoes", "discogan")
    assert got == want
    assert got["best"]["trial_id"] == 1 and got["ranking"] == [1, 3, 0]


def test_hp_trial_commands_name_the_port(tmp_path, monkeypatch):
    """Angle tasks run the port's angle trainer, others its translation
    trainer; a slot on a card sets CUDA_VISIBLE_DEVICES, an overflow slot
    passes --device cpu (no environment switch)."""
    captured = []

    def fake_popen(cmd, stdout=None, stderr=None, env=None):
        captured.append((cmd, env))
        return SimpleNamespace(pid=1)

    monkeypatch.setattr(hps.subprocess, "Popen", fake_popen)
    for task in ("edges2shoes", "car2car"):
        args = hps.parse_args([f"--output_dir={tmp_path}", f"--task_name={task}"])
        hps.run_trial(HP, args, 0, 0, card=3)
        hps.run_trial(HP, args, 1, 1, card=None)
    (c0, e0), (c1, e1), (c2, _), (c3, _) = captured
    assert c0[1:3] == ["-m", "discogan_modernized_torch.cli.image_translation"]
    assert c2[1:3] == ["-m", "discogan_modernized_torch.cli.angle_pairing"]
    assert e0["CUDA_VISIBLE_DEVICES"] == "3" and "--device=cpu" not in c0
    assert "--device=cpu" in c1 and "--device=cpu" in c3
    assert e1.get("CUDA_VISIBLE_DEVICES") == os.environ.get("CUDA_VISIBLE_DEVICES")
    for _, env in captured:
        for switch in ("DISCOGAN_FORCE_CPU", "DISCOGAN_NUM_CHIPS", "DISCOGAN_WORKER_SLOT"):
            assert env.get(switch) == os.environ.get(switch)
    # the trainer's parser takes every flag of a trial's command
    from discogan_modernized_torch.cli.common import angle_parser, translation_parser

    for cmd, parser in ((c1, translation_parser()), (c3, angle_parser())):
        parser.parse_args(cmd[3:])


def test_hp_slot_pool(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert hps.slot_pool(hps.parse_args(["--workers=3"])) == [0, None, None]
    assert hps.slot_pool(hps.parse_args([])) == [0]
    assert hps.slot_pool(hps.parse_args(["--gpus=2,5"])) == [2, 5]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert hps.slot_pool(hps.parse_args(["--workers=1"])) == [None]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        hps.slot_pool(hps.parse_args([]))


class _FakeProc:
    def __init__(self, name, events, finish_after=None):
        self.name, self.events, self.finish_after = name, events, finish_after
        self.polls, self.pid, self.returncode = 0, 4242, None

    def poll(self):
        if self.returncode is not None:
            return self.returncode
        self.polls += 1
        if self.finish_after is not None and self.polls >= self.finish_after:
            self.returncode = 0
            self.events.append(("finish", self.name))
        return self.returncode

    def terminate(self):
        if self.returncode is None:
            self.returncode = -15
            self.events.append(("terminate", self.name))

    def kill(self):
        self.terminate()

    def wait(self, timeout=None):
        if self.returncode is None:
            self.returncode = 0
        return self.returncode


def test_hp_search_early_stops_any_concurrent_trial(tmp_path, monkeypatch):
    events = []

    def fake_run_trial(hp, args, slot, trial_id, card=None):
        rdir = tmp_path / f"t{trial_id}"
        rdir.mkdir()
        log = rdir / "train.log"
        log.write_text("RECON: 0.5000/0.5000\nRECON: 0.5000/0.5000\n" if trial_id == 1
                       else "no recon lines here\n")
        proc = _FakeProc(f"trial{trial_id}", events,
                         finish_after=6 if trial_id == 0 else None)
        return proc, rdir, {"trial_id": trial_id, "slot_id": slot, "log_file": str(log),
                            "start_timestamp": time.time(), "hyperparameters": hp}

    monkeypatch.setattr(hps, "run_trial", fake_run_trial)
    monkeypatch.setattr(hps, "analyze_results", lambda *a, **k: {"ok": True})
    hps.main(["--task_name=edges2shoes", "--trials=2", "--workers=2", "--early_stopping",
              "--patience=1", "--poll_interval=0.01", f"--output_dir={tmp_path}/hp",
              "--seed=0"])
    assert events.index(("terminate", "trial1")) < events.index(("finish", "trial0"))


# -- batch-size bisection -----------------------------------------------------

@pytest.mark.parametrize("limit, flags", [(96, []), (192, ["--image_size=512"]),
                                          (500, []), (8, []),
                                          (200, ["--step=8", "--max_batch=256"])])
def test_bisection_equals_jax(limit, flags, monkeypatch, tmp_path):
    """With the out-of-memory limit faked, the search lands where JAX's
    does, with its margin and history."""
    argv = [f"--output={tmp_path}/out.json", *flags]
    monkeypatch.setattr(jax_bso, "test_batch_size",
                        lambda bs, *a, **k: (bs <= limit, 0.5 if bs <= limit else None))
    want = jax_bso.find_optimal_batch_size(jax_bso.parse_args(argv))
    got = bso.find_optimal_batch_size(
        bso.parse_args(argv),
        probe=lambda bs: (bs <= limit, 0.5 if bs <= limit else None, None))
    for h in got["history"]:
        assert h.pop("peak_utilization") is None
    assert got == want


def test_bisection_honours_the_target(monkeypatch, tmp_path):
    argv = [f"--output={tmp_path}/out.json", "--target_memory=0.6"]
    monkeypatch.setattr(jax_bso, "test_batch_size",
                        lambda bs, *a, **k: (True, bs / 400))
    want = jax_bso.find_optimal_batch_size(jax_bso.parse_args(argv))
    got = bso.find_optimal_batch_size(bso.parse_args(argv),
                                      probe=lambda bs: (True, bs / 400, bs / 300))
    assert got["max_working_batch_size"] == want["max_working_batch_size"] == 240


def test_batch_probe_forward_on_the_cpu(tmp_path):
    """One real probe of the forward graph at 16px on the CPU, and the
    search's json and commands through main."""
    probe = bso.Probe(16, "discogan", torch.device("cpu"), train_step=False)
    assert probe(2) == (True, None, None)
    out = tmp_path / "r.json"
    probe_small = bso.Probe(16, "gan", torch.device("cpu"), train_step=True)
    result = bso.find_optimal_batch_size(
        bso.parse_args(["--device=cpu", "--image_size=16", "--min_batch=2", "--max_batch=4",
                        "--step=2", "--model_arch=gan", f"--output={out}"]),
        probe=probe_small)
    assert result["max_working_batch_size"] == 4


def test_batch_probe_holds_the_trainers_state(monkeypatch, tmp_path):
    """The probe holds the optimizer state the printed trainer commands
    run (the trainers' default slim state), and the json names it."""
    from discogan_modernized_torch.cli.common import translation_parser

    probe = bso.Probe(16, "gan", torch.device("cpu"), train_step=False)
    assert probe.cfg.slim_state == translation_parser().get_default("slim_state") == "mv"
    assert {m.dtype for m in probe.ts.opt_gen.m} == {torch.bfloat16}
    monkeypatch.setattr(bso, "find_optimal_batch_size", lambda args: {
        "recommended_batch_size": 0, "max_working_batch_size": 0})
    bso.main([f"--output={tmp_path}/r.json", "--device=cpu"])
    assert json.loads((tmp_path / "r.json").read_text())["slim_state"] == "mv"


def test_batch_size_main_names_the_port(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(bso, "find_optimal_batch_size", lambda args: {
        "recommended_batch_size": 16, "max_working_batch_size": 32})
    bso.main([f"--output={tmp_path}/r.json", "--device=cpu"])
    out = capsys.readouterr().out
    assert "-m discogan_modernized_torch.cli.image_translation" in out
    assert "-m discogan_modernized_torch.cli.distributed_image_translation" in out


# -- the monitor --------------------------------------------------------------

SMI_CSV = ("0, NVIDIA H100 80GB HBM3, 41, 97, 70000, 81559, 512.31\n"
           "1, NVIDIA H100 80GB HBM3, 38, 0, 2, 81559, [N/A]\n")


@pytest.fixture
def fake_smi(monkeypatch):
    real = subprocess.run

    def run(cmd, *a, **k):
        if cmd and cmd[0] == "nvidia-smi":
            assert cmd == mon_mod.SMI_QUERY
            return SimpleNamespace(stdout=SMI_CSV, returncode=0)
        return real(cmd, *a, **k)

    monkeypatch.setattr(mon_mod.subprocess, "run", run)


def test_device_stats_from_nvidia_smi(fake_smi):
    d0, d1 = mon_mod.device_stats()
    assert d0["id"] == 0 and d0["kind"] == "NVIDIA H100 80GB HBM3"
    assert d0["temperature_c"] == 41 and d0["gpu_utilization"] == 97
    assert d0["bytes_in_use"] == 70000 * 2**20 and d0["bytes_limit"] == 81559 * 2**20
    assert d0["utilization"] == pytest.approx(70000 / 81559)
    assert d0["power_w"] == pytest.approx(512.31) and d1["power_w"] is None


def test_device_stats_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(mon_mod.subprocess, "run", missing)
    assert "error" in mon_mod.device_stats()[0]


def test_host_stats_match_jax():
    assert set(mon_mod.host_stats()) == set(jax_mon.host_stats())


def test_trainer_scripts_take_the_port_modules():
    for name in jax_mon.TRAINER_SCRIPTS:
        assert name in mon_mod.TRAINER_SCRIPTS
    for module in ("image_translation", "distributed_image_translation", "angle_pairing"):
        assert f"discogan_modernized_torch.cli.{module}" in mon_mod.TRAINER_SCRIPTS
    cmd = mon_mod.launch_command("edges2shoes", "discogan")
    assert cmd[1:3] == ["-m", "discogan_modernized_torch.cli.image_translation"]


def test_monitor_poll_and_restart_tracking(tmp_path, monkeypatch, fake_smi):
    args = mon_mod.parse_args([f"--log_dir={tmp_path}", "--iterations=1", "--no-interactive",
                               "--auto-restart", "--mem-alert=0.5"])
    mon = mon_mod.Monitor(args)
    jobs = [{"pid": 12345, "cmdline": "python -m discogan_modernized_torch.cli."
             "image_translation --task_name=edges2shoes", "task_name": "edges2shoes"}]
    monkeypatch.setattr(mon_mod, "find_training_jobs", lambda: jobs)
    snap = mon.poll_once()
    assert 12345 in mon.known_jobs and snap["devices"][0]["utilization"] > 0.5
    assert "메모리 사용률" in (tmp_path / "monitor.log").read_text()
    launched = []
    monkeypatch.setattr(mon_mod, "find_training_jobs", lambda: [])
    monkeypatch.setattr(mon_mod.subprocess, "Popen",
                        lambda cmd, **kw: launched.append(cmd) or SimpleNamespace(pid=1))
    mon.poll_once()
    assert launched and "--task_name=edges2shoes" in " ".join(launched[0])
    assert (tmp_path / "telemetry.json").exists()


def test_monitor_restart_cap(tmp_path, monkeypatch):
    mon = mon_mod.Monitor(mon_mod.parse_args([f"--log_dir={tmp_path}", "--no-interactive",
                                              "--auto-restart"]))
    launched = []
    monkeypatch.setattr(mon_mod.subprocess, "Popen",
                        lambda cmd, **kw: launched.append(cmd) or SimpleNamespace(pid=1))
    job = {"pid": 1, "cmdline": "python image_translation.py --task_name=x", "task_name": "x"}
    ckpt = tmp_path / "models" / "x" / "discogan" / "20260101_000000"
    for n in range(mon_mod.MAX_RESTARTS + 2):
        mon.check_and_restart_jobs([dict(job, argv=launched[-1] if launched else None)])
        mon.check_and_restart_jobs([])
        if n == 0:  # a save appears after the first run: later restarts resume
            ckpt.mkdir(parents=True)
            (ckpt / "train_state_meta.json").write_text('{"iters": 7}')
    assert len(launched) == mon_mod.MAX_RESTARTS


def test_monitor_restart_resumes_from_the_train_state(tmp_path, monkeypatch):
    ckpt = tmp_path / "models" / "edges2shoes" / "discogan" / "20260101_000000"
    ckpt.mkdir(parents=True)
    (ckpt / "train_state_meta.json").write_text('{"iters": 7}')
    launched = []
    monkeypatch.setattr(mon_mod.subprocess, "Popen",
                        lambda cmd, **kw: launched.append(cmd) or SimpleNamespace(pid=1))
    mon = mon_mod.Monitor(mon_mod.parse_args([f"--log_dir={tmp_path}/logs",
                                              "--no-interactive", "--auto-restart"]))
    job = {"pid": 9, "task_name": "edges2shoes",
           "cmdline": ("python -m discogan_modernized_torch.cli.image_translation "
                       f"--task_name=edges2shoes --models_dir={tmp_path}/models")}
    mon.check_and_restart_jobs([job])
    mon.check_and_restart_jobs([])
    assert launched[0][-1] == f"--resume={ckpt}"
    launched.clear()
    mon2 = mon_mod.Monitor(mon_mod.parse_args([f"--log_dir={tmp_path}/logs2",
                                               "--no-interactive", "--auto-restart"]))
    job2 = {"pid": 10, "task_name": "x", "cmdline": "python image_translation.py "
            f"--task_name=x --models_dir={tmp_path}/nothing"}
    mon2.check_and_restart_jobs([job2])
    mon2.check_and_restart_jobs([])
    assert launched and not any(a.startswith("--resume=") for a in launched[0])


def test_monitor_proc_argv_cwd_roundtrip(tmp_path):
    p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)",
                          "--task_name=has space"], cwd=tmp_path)
    try:
        deadline = time.time() + 5
        argv = cwd = None
        while time.time() < deadline:
            argv, cwd = mon_mod._proc_argv_cwd(p.pid)
            if argv:
                break
            time.sleep(0.05)
        assert argv[-1] == "--task_name=has space"
        assert Path(cwd) == tmp_path
    finally:
        p.kill()
        p.wait()


def test_monitor_restart_uses_argv_and_cwd(tmp_path, monkeypatch):
    mon = mon_mod.Monitor(mon_mod.parse_args([f"--log_dir={tmp_path}/logs",
                                              "--no-interactive", "--auto-restart"]))
    calls = []
    monkeypatch.setattr(mon_mod.subprocess, "Popen",
                        lambda cmd, **kw: calls.append((cmd, kw)) or SimpleNamespace(pid=1))
    argv = [sys.executable, "-m", "discogan_modernized_torch.cli.image_translation",
            "--task_name=x", "--results_dir=./my dir"]
    job = {"pid": 5, "cmdline": " ".join(argv), "task_name": "x", "argv": argv,
           "cwd": str(tmp_path)}
    mon.check_and_restart_jobs([job])
    mon.check_and_restart_jobs([])
    cmd, kw = calls[0]
    assert cmd == argv and kw["cwd"] == str(tmp_path)
    assert kw["stdout"] is not subprocess.DEVNULL


def _training_log(root: Path, iters: int):
    d = root / "results" / "edges2shoes" / "discogan" / "20260101_000000"
    d.mkdir(parents=True, exist_ok=True)
    (d / "training_log.txt").write_text(LOG_LINE.format(i=iters, a="0.1", b="0.1"))


def test_monitor_step_rate_and_stall_alert(tmp_path):
    mon = mon_mod.Monitor(mon_mod.parse_args([f"--log_dir={tmp_path}/logs",
                                              "--no-interactive", "--stall-polls=2"]))
    argv = ["python", "-m", "discogan_modernized_torch.cli.image_translation",
            "--task_name=edges2shoes", f"--results_dir={tmp_path}/results"]
    job = {"pid": 77, "cmdline": " ".join(argv), "task_name": "edges2shoes", "argv": argv,
           "cwd": str(tmp_path)}
    _training_log(tmp_path, 10)
    mon.update_job_progress([job])
    assert job["iters"] == 10
    _training_log(tmp_path, 30)
    job2 = dict(job)
    mon.update_job_progress([job2])
    assert job2["iters"] == 30 and job2["step_rate"] > 0
    time.sleep(3.0 * mon._log_gap[77] + 0.05)
    for _ in range(2):
        mon.update_job_progress([dict(job)])
    assert "정체" in (tmp_path / "logs" / "monitor.log").read_text()


# -- the trainer's memory sidecar ---------------------------------------------

def _train_16px(tmp_path, monkeypatch, stats):
    from discogan_modernized_torch.cli import image_translation
    from discogan_modernized_torch.train import loop

    monkeypatch.setattr(loop, "device_memory", stats)
    result_path, _ = image_translation.main([
        "--device=cpu", "--task_name=synthetic", "--model_arch=gan", "--image_size=16",
        "--batch_size=8", "--epochs=1", "--model_save_interval=16",
        "--image_save_interval=1000", f"--results_dir={tmp_path}/results",
        f"--models_dir={tmp_path}/models"])
    return Path(result_path)


def test_trainer_sidecar_format_and_monitors(tmp_path, monkeypatch):
    """With the card's stats stubbed, the trainer appends a record a save
    in JAX's format; the port's monitor and the JAX one both read the
    newest of them from the job's run."""
    def stats(device):
        return [{"id": 0, "bytes_in_use": 1234, "bytes_limit": 8192}]

    run = _train_16px(tmp_path, monkeypatch, stats)
    lines = (run / "hbm_telemetry.jsonl").read_text().splitlines()
    records = [json.loads(s) for s in lines]
    assert [r["iter"] for r in records] == [0, 16]
    for r in records:
        assert set(r) == {"t", "iter", "devices"}
        assert r["devices"] == [{"id": 0, "bytes_in_use": 1234, "bytes_limit": 8192}]
    argv = ["python", "-m", "discogan_modernized_torch.cli.image_translation",
            "--task_name=synthetic", "--model_arch=gan", f"--results_dir={tmp_path}/results"]
    job = {"pid": 1, "cmdline": " ".join(argv), "argv": argv, "cwd": str(tmp_path),
           "task_name": "synthetic"}
    for module in (mon_mod, jax_mon):
        m = module.Monitor(module.parse_args([f"--log_dir={tmp_path}/{module.__name__}",
                                              "--no-interactive"]))
        assert m._job_hbm(dict(job)) == records[-1]


def test_sidecar_writes_nothing_on_the_cpu(tmp_path):
    from discogan_modernized_torch.train import loop

    assert loop.device_memory(torch.device("cpu")) is None
    loop.hbm_sample(tmp_path, 0, torch.device("cpu"))
    assert not (tmp_path / "hbm_telemetry.jsonl").exists()


def test_sidecar_failure_never_stops_training(tmp_path, monkeypatch):
    from discogan_modernized_torch.train import loop

    def broken(device):
        raise RuntimeError("no stats")

    monkeypatch.setattr(loop, "device_memory", broken)
    loop.hbm_sample(tmp_path, 0, torch.device("cuda"))
    monkeypatch.setattr(loop, "device_memory", lambda device: [{"id": 0}])
    loop.hbm_sample(tmp_path / "missing" / "dir", 0, torch.device("cuda"))
    assert not (tmp_path / "hbm_telemetry.jsonl").exists()


# -- end to end ---------------------------------------------------------------

@pytest.mark.slow
def test_single_trial_end_to_end(tmp_path, monkeypatch):
    """One real trial subprocess of the port's trainer on the CPU (an
    overflow slot: no card here), through the whole protocol."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    analysis = hps.main(["--task_name=synthetic", "--model_arch=gan", "--trials=1",
                         "--base_epochs=1", "--batch_size=8", "--image_size=16",
                         f"--output_dir={tmp_path}/hp", "--workers=1", "--seed=0",
                         "--poll_interval=2"])
    base = tmp_path / "hp" / "synthetic" / "gan"
    (td,) = base.glob("trial_0_*")
    info = json.loads((td / "trial_info.json").read_text())
    assert info["status"] == "completed" and info["returncode"] == 0
    assert info["device"] == "cpu" and "--device=cpu" in info["command"]
    assert analysis["best"]["metrics"]["avg_recon_loss"] is not None
