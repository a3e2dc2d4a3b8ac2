"""The port's --resume on the CPU, in f32 and under slim_state=all: a run
stopped at iteration k and resumed to N ends with the train state of the
uninterrupted N-iteration run, bit for bit (every parameter, running
statistic, Adam moment and step count of train_state.pt).

N = 16: two epochs of the 256-image synthetic task at batch 32, 16px. The
stops: at the epoch boundary (a run of --epochs=1, resumed with
--epochs=2), mid-epoch (a run that crashes at iteration 6, resumed from
its periodic save of iteration 4), and by SIGTERM at the end of iteration
10 (the trainer saves and returns). Also: the log of a resumed run (JAX's test_full_state_resume,
tests/test_cli.py), and a state of another slim state, architecture or
image size is refused before anything is written.
"""

import json
import os
import re
import signal

import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

NB = 8  # batches an epoch: 256 synthetic pairs at batch 32
N = 2 * NB


def run(tmp_path, tag, *extra, observer=None, slim="off", epochs=2):
    from discogan_modernized_torch.cli.common import parse_with_config, translation_parser
    from discogan_modernized_torch.train.loop import run_training

    args = parse_with_config(translation_parser(), [
        "--device=cpu", "--task_name=synthetic", "--model_arch=gan",
        "--image_size=16", "--batch_size=32", f"--epochs={epochs}",
        "--precision=f32", f"--slim_state={slim}", "--log_interval=1",
        "--image_save_interval=1000", "--model_save_interval=1000",
        f"--results_dir={tmp_path}/{tag}/r", f"--models_dir={tmp_path}/{tag}/m",
        *extra])
    return run_training(args, observer=observer)


class Crash(Exception):
    pass


class CrashAt:
    """Raises at the start of iteration k, as a run that dies there."""

    def __init__(self, k):
        self.k = k

    def begin(self, iters, kind):
        if iters == self.k:
            raise Crash(iters)

    def end(self, iters, kind, losses):
        pass


class SigtermAt:
    """Sends this process SIGTERM at the end of iteration k."""

    def __init__(self, k):
        self.k = k

    def begin(self, iters, kind):
        pass

    def end(self, iters, kind, losses):
        if iters == self.k:
            os.kill(os.getpid(), signal.SIGTERM)


def load_state(model_path):
    return torch.load(model_path / "train_state.pt", weights_only=True)


def assert_same_state(a, b):
    for name in a["models"]:
        for k, v in a["models"][name].items():
            w = b["models"][name][k]
            assert v.dtype == w.dtype and torch.equal(v, w), (name, k)
    for key in ("opt_gen", "opt_dis"):
        assert a[key]["step"] == b[key]["step"]
        for part in ("m", "v"):
            for i, (v, w) in enumerate(zip(a[key][part], b[key][part], strict=True)):
                assert v.dtype == w.dtype and torch.equal(v, w), (key, part, i)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """slim state -> the uninterrupted run's final train state."""
    cache = {}

    def get(slim):
        if slim not in cache:
            _, model_path = run(tmp_path_factory.mktemp("full"), "full", slim=slim)
            meta = json.loads((model_path / "train_state_meta.json").read_text())
            assert meta["iters"] == N
            cache[slim] = load_state(model_path)
        return cache[slim]
    return get


@pytest.mark.parametrize("slim", ["off", "all"])
def test_resume_at_epoch_boundary_is_bit_exact(slim, tmp_path, uninterrupted):
    _, first = run(tmp_path, "a", slim=slim, epochs=1)
    assert json.loads((first / "train_state_meta.json").read_text())["iters"] == NB
    _, resumed = run(tmp_path, "b", f"--resume={first}", slim=slim)
    state = load_state(resumed)
    if slim == "all":
        assert state["models"]["gen_B"]["encoder.0.weight"].dtype == torch.bfloat16
        assert state["models"]["gen_B"]["encoder.3.running_mean"].dtype == torch.float32
    assert_same_state(state, uninterrupted(slim))


@pytest.mark.parametrize("slim", ["off", "all"])
def test_resume_mid_epoch_after_a_crash_is_bit_exact(slim, tmp_path, uninterrupted):
    """The periodic save at iteration 4 holds 5 iterations' training and
    says so (iters 5), so a resume from it trains iteration 5 next."""
    with pytest.raises(Crash):
        run(tmp_path, "a", "--model_save_interval=4", slim=slim, observer=CrashAt(6))
    first = next((tmp_path / "a" / "m").rglob("train_state.pt")).parent
    assert json.loads((first / "train_state_meta.json").read_text())["iters"] == 5
    _, resumed = run(tmp_path, "b", f"--resume={first}", slim=slim)
    assert_same_state(load_state(resumed), uninterrupted(slim))


@pytest.mark.parametrize("slim", ["off", "all"])
def test_resume_after_sigterm_is_bit_exact(slim, tmp_path, uninterrupted):
    before = signal.getsignal(signal.SIGTERM)
    _, first = run(tmp_path, "a", slim=slim, observer=SigtermAt(10))
    assert signal.getsignal(signal.SIGTERM) is before  # the caller's handler is back
    meta = json.loads((first / "train_state_meta.json").read_text())
    assert meta["preempted"] is True and meta["iters"] == 11
    assert (first / "gen_B_11.pth").exists()
    assert not (first / "gen_B_final.pth").exists()
    result, resumed = run(tmp_path, "b", f"--resume={first}", slim=slim)
    assert_same_state(load_state(resumed), uninterrupted(slim))
    logged = [int(i) for i in re.findall(r"Iter \[(\d+)/16\]",
                                         (result / "training_log.txt").read_text())]
    assert logged == list(range(11, N))


def test_resumed_log_continues_to_the_original_total(tmp_path):
    """JAX's test_full_state_resume: the resumed run trains only the second
    epoch and logs it against the original total."""
    _, first = run(tmp_path, "a", epochs=1)
    result, _ = run(tmp_path, "b", f"--resume={first}", "--log_interval=5")
    log = (result / "training_log.txt").read_text()
    assert "Iter [10/16]" in log and "Iter [15/16]" in log, log
    assert "Iter [5/16]" not in log  # the finished epoch is not run again
    assert re.findall(r"Iter \[(\d+)/", log) == ["10", "15"]


@pytest.mark.parametrize("flag,value", [("--slim_state", "all"),
                                        ("--model_arch", "discogan"),
                                        ("--image_size", "32")])
def test_a_mismatched_state_is_refused(flag, value, tmp_path):
    _, first = run(tmp_path, "a", epochs=1)
    with pytest.raises(ValueError, match="train state was saved as"):
        run(tmp_path, "b", f"--resume={first}", f"{flag}={value}")
    assert not (tmp_path / "b").exists()


def test_resume_from_a_directory_without_a_state_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError, match="no train state"):
        run(tmp_path, "b", f"--resume={tmp_path / 'nothing'}")
    assert not (tmp_path / "b").exists()
