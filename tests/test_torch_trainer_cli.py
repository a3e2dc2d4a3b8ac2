"""The port's trainer CLI on the CPU at 16px: the training_log.txt contract
(tests/test_cli.py's regex), the sample grid, the reference-layout .pth
files (loaded strict into tests/torch_ref.py's modules and into the
port's inference CLI), the train-state file, and the flags the port does
not take yet."""

import re

import numpy as np
import pytest
import torch
from PIL import Image

from discogan_modernized_torch.cli.image_translation import main
from tests.torch_ref import RefDiscriminator, RefGenerator

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


@pytest.mark.parametrize("flag", ["--paired", "--lean_dis", "--remat=on",
                                  "--remat_policy=conv", "--steps_per_call=2",
                                  "--bn_sync", "--xla_copts=a=b", "--profile=p",
                                  "--resume=r", "--ckpt_backend=npz"])
def test_unported_flags_are_refused(flag, tmp_path):
    with pytest.raises(SystemExit):
        run(tmp_path, flag)


@pytest.mark.parametrize("extra,error", [
    (("--slim_state=all",), NotImplementedError),
    (("--task_name=edges2shoes",), SystemExit),
    (("--model_arch=cyclegan",), SystemExit),
])
def test_what_is_not_ported_raises_before_training(extra, error, tmp_path):
    with pytest.raises(error):
        run(tmp_path, *extra)
    assert not (tmp_path / "models").exists()
