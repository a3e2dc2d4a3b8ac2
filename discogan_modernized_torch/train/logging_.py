"""training_log.txt writer, a machine-read contract.

The exact line format (4 decimals, ref image_translation.py:393-402) is
regex-scraped by the HP search for early stopping and ranking
(hyperparameter_search.py:219, :269-292), so it is reproduced verbatim:

    Iter [<i>/<total>] GEN: a/b, FM: a/b, RECON: a/b, DIS: a/b

The angle-pairing trainer logs without the FM field
(angle_pairing.py:350-354); ``fm=False`` renders that variant.
"""

from __future__ import annotations

from pathlib import Path


class TrainingLogger:
    def __init__(self, log_file, timestamp: str, task_name: str, model_arch: str,
                 batch_size: int, learning_rate: float):
        self.log_file = Path(log_file)
        self.log_file.parent.mkdir(parents=True, exist_ok=True)
        with open(self.log_file, "w") as f:
            f.write(f"Training started at {timestamp}\n")
            f.write(f"Task: {task_name}, Model: {model_arch}\n")
            f.write(f"Batch size: {batch_size}, Learning rate: {learning_rate}\n\n")

    def format_line(self, iters: int, total: int, losses: dict, fm: bool = True) -> str:
        parts = [f"Iter [{iters}/{total}] ",
                 f"GEN: {losses['gen_A']:.4f}/{losses['gen_B']:.4f}, "]
        if fm:
            parts.append(f"FM: {losses['fm_A']:.4f}/{losses['fm_B']:.4f}, ")
        parts.append(f"RECON: {losses['recon_A']:.4f}/{losses['recon_B']:.4f}, ")
        parts.append(f"DIS: {losses['dis_A']:.4f}/{losses['dis_B']:.4f}")
        return "".join(parts)

    def log(self, iters: int, total: int, losses: dict, fm: bool = True,
            echo: bool = True) -> str:
        msg = self.format_line(iters, total, losses, fm)
        if echo:
            print(msg)
        with open(self.log_file, "a") as f:
            f.write(msg + "\n")
        return msg
