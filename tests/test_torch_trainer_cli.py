"""The port's trainer CLI on the CPU at 16px: the training_log.txt contract
(tests/test_cli.py's regex), the sample grid, the reference-layout .pth
files (loaded strict into tests/torch_ref.py's modules and into the
port's inference CLI), the train-state file, a real-data task over an
edges2shoes tree and CelebA's style flags, and the flags the port does not
take yet."""

import re

import numpy as np
import pytest
import torch
from PIL import Image

from discogan_modernized_torch.cli.image_translation import main
from tests.torch_ref import RefDiscriminator, RefGenerator
from tests.torch_threads import one_torch_thread  # noqa: F401

LINE = re.compile(
    r"Iter \[\d+/\d+\] GEN: \d+\.\d{4}/\d+\.\d{4}, FM: \d+\.\d{4}/\d+\.\d{4}, "
    r"RECON: \d+\.\d{4}/\d+\.\d{4}, DIS: \d+\.\d{4}/\d+\.\d{4}")


def run(tmp_path, *extra):
    return main(["--device=cpu", "--task_name=synthetic", "--model_arch=gan",
                 "--image_size=16", "--batch_size=8", "--epochs=1",
                 "--log_interval=10", "--image_save_interval=20",
                 "--model_save_interval=20", f"--results_dir={tmp_path}/results",
                 f"--models_dir={tmp_path}/models", *extra])


def test_trainer_end_to_end(tmp_path):
    result_path, model_path = run(tmp_path)
    log = (result_path / "training_log.txt").read_text()
    assert log.startswith("Training started at ")
    assert len(LINE.findall(log)) == 4, log  # iterations 0, 10, 20, 30 of 32
    assert (result_path / "samples" / "samples_iter_0.png").exists()
    for name in ("gen_A", "gen_B", "dis_A", "dis_B"):
        for tag in ("0", "20", "final"):
            assert (model_path / f"{name}_{tag}.pth").exists()
    meta = (model_path / "train_state_meta.json").read_text()
    assert '"iters": 32' in meta
    state = torch.load(model_path / "train_state.pt", weights_only=True)
    assert state["opt_gen"]["step"] == 21 and state["opt_dis"]["step"] == 11
    assert state["opt_gen"]["m"][0].dtype == torch.bfloat16  # slim_state=mv

    RefGenerator(16).load_state_dict(
        torch.load(model_path / "gen_B_final.pth", weights_only=True), strict=True)
    sd = torch.load(model_path / "dis_B_final.pth", weights_only=True)
    RefDiscriminator(16).load_state_dict(sd, strict=True)
    assert sd["bn2.num_batches_tracked"].dtype == torch.int64

    from discogan_modernized_torch.cli.inference import main as infer_main

    img = tmp_path / "input.png"
    Image.fromarray((np.random.RandomState(0).rand(32, 32, 3) * 255)
                    .astype(np.uint8)).save(img)
    assert infer_main(["--device=cpu", f"--model_path={model_path}",
                       f"--input_path={img}", f"--output_dir={tmp_path}/inf",
                       "--image_size=16"]) == 0
    assert (tmp_path / "inf" / "input_result.png").exists()


@pytest.mark.parametrize("flag", ["--parallel_mode=gspmd", "--xla_copts=a=b",
                                  "--ckpt_backend=npz"])
def test_unported_flags_are_refused(flag, tmp_path):
    with pytest.raises(SystemExit):
        run(tmp_path, flag)


@pytest.mark.parametrize("flag,line", [
    ("--steps_per_call=4", "dataset on the CPU for --steps_per_call"),
    ("--no_device_cache", "dataset off (--no_device_cache)"),
    ("--profile=trace", "steps_per_call 1 (auto)")])
def test_multistep_flags_train(flag, line, tmp_path, capsys):
    """The multi-step driver's flags through the trainer: it trains, every
    logged loss finite, its path line says what it took; --profile writes
    its trace."""
    if flag.startswith("--profile"):
        flag = f"--profile={tmp_path / 'trace'}"
    result_path, _ = run(tmp_path, flag)
    lines = LINE.findall((result_path / "training_log.txt").read_text())
    assert len(lines) == 4
    assert all(np.isfinite(float(v)) for v in re.findall(r"\d+\.\d{4}", "".join(lines)))
    assert line in capsys.readouterr().out
    if flag.startswith("--profile"):
        assert [p.name for p in (tmp_path / "trace").iterdir()] == ["trace_iters_2-9.json"]


@pytest.mark.parametrize("flag,key,value", [
    ("--paired", "paired", True), ("--lean_dis", "lean_dis", True),
    ("--remat=on", "remat", True), ("--remat_policy=conv", "remat_policy", "conv")])
def test_variant_flags_train(flag, key, value, tmp_path):
    """The train step's graph variants through the trainer: every logged
    loss finite, the variant in the train state's meta."""
    import json

    result_path, model_path = run(tmp_path, flag)
    log = (result_path / "training_log.txt").read_text()
    lines = LINE.findall(log)
    assert len(lines) == 4, log
    assert all(np.isfinite(float(v)) for v in re.findall(r"\d+\.\d{4}", "".join(lines)))
    meta = json.loads((model_path / "train_state_meta.json").read_text())
    assert meta["variants"][key] == value


@pytest.mark.parametrize("extra,error", [
    (("--slim_state=fp8",), SystemExit),
    (("--task_name=nosuchtask",), ValueError),
    (("--model_arch=cyclegan",), SystemExit),
])
def test_what_is_not_ported_raises_before_training(extra, error, tmp_path):
    with pytest.raises(error):
        run(tmp_path, *extra)
    assert not (tmp_path / "models").exists()


def test_slim_state_all_trains(tmp_path):
    _, model_path = run(tmp_path, "--slim_state=all")
    state = torch.load(model_path / "train_state.pt", weights_only=True)
    assert state["models"]["gen_B"]["encoder.0.weight"].dtype == torch.bfloat16
    assert state["models"]["gen_B"]["encoder.3.running_var"].dtype == torch.float32
    assert state["opt_gen"]["v"][0].dtype == torch.bfloat16
    # The reference layout stays f32.
    sd = torch.load(model_path / "gen_B_final.pth", weights_only=True)
    assert sd["encoder.0.weight"].dtype == torch.float32
    RefGenerator(16).load_state_dict(sd, strict=True)


@pytest.fixture()
def edges2shoes(tmp_path, monkeypatch):
    """tests/test_cli.py's edges2shoes tree: side-by-side 512x256 JPEGs."""
    rng = np.random.RandomState(0)
    root = tmp_path / "datasets"
    for split, n in (("train", 12), ("test", 3)):
        d = root / "edges2shoes" / split
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.rand(256, 512, 3) * 255).astype(np.uint8)
                            ).save(d / f"{i}_AB.jpg")
    monkeypatch.setenv("DISCOGAN_DATASETS_ROOT", str(root))
    monkeypatch.setenv("DISCOGAN_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    return root


def test_edges2shoes_real_data_end_to_end(edges2shoes, tmp_path):
    """Resolver -> AB-crop decode through the cache -> loader -> training, as
    tests/test_cli.py's test of the same name drives the JAX trainer."""
    result_path, model_path = main([
        "--device=cpu", "--task_name=edges2shoes", "--model_arch=discogan",
        "--image_size=16", "--batch_size=4", "--epochs=2", "--log_interval=2",
        "--image_save_interval=1000000", "--model_save_interval=1000000",
        f"--results_dir={tmp_path}/r", f"--models_dir={tmp_path}/m"])
    log = (result_path / "training_log.txt").read_text()
    assert "Task: edges2shoes, Model: discogan" in log
    assert len(LINE.findall(log)) == 3, log  # iterations 0, 2, 4 of 6
    assert (model_path / "gen_A_final.pth").exists()
    assert len(list((tmp_path / "cache").glob("*.dat"))) == 2  # one a domain
    assert '"iters": 6' in (model_path / "train_state_meta.json").read_text()


def test_celebA_style_flags_and_n_test(tmp_path, monkeypatch):
    rng = np.random.RandomState(1)
    celeba = tmp_path / "datasets" / "celebA"
    (celeba / "img_align_celeba").mkdir(parents=True)
    lines = ["12", "Male Smiling"]
    for i in range(12):
        name = f"{i:06d}.jpg"
        Image.fromarray((rng.rand(20, 20, 3) * 255).astype(np.uint8)).save(
            celeba / "img_align_celeba" / name)
        lines.append(f"{name} {'1' if i % 2 == 0 else '-1'} {'1' if i < 6 else '-1'}")
    (celeba / "list_attr_celeba.txt").write_text("\n".join(lines) + "\n")
    monkeypatch.setenv("DISCOGAN_DATASETS_ROOT", str(tmp_path / "datasets"))
    monkeypatch.setenv("DISCOGAN_DATA_CACHE", "0")
    result_path, model_path = main([
        "--device=cpu", "--task_name=celebA", "--style_A=Male", "--n_test=2",
        "--model_arch=gan", "--image_size=16", "--batch_size=2", "--epochs=1",
        "--image_save_interval=1000000", "--model_save_interval=1000000",
        f"--results_dir={tmp_path}/r", f"--models_dir={tmp_path}/m"])
    # The style level in both paths (ref image_translation.py:226-235).
    assert result_path.parts[-4:-1] == ("celebA", "Male", "gan")
    assert model_path.parts[-4:-1] == ("celebA", "Male", "gan")
    # 6 Male and 6 non-Male rows, 2 of each held out: 4 pairs, 2 batches.
    assert "Iter [0/2]" in (result_path / "training_log.txt").read_text()
