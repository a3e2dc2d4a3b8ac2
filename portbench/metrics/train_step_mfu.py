"""The whole step's share of the card's peak: the model's conv flops of
the timed window's iterations (counts/conv.py, no recomputation) over the
window's seconds times the peak of the configuration's math type. Taken
from the traced run's timed window, with the profiler off."""

from portbench.counts import conv, peaks


def read(s: dict):
    if s["device_type"] != "cuda" or not s["timed"]["iterations"]:
        return None
    flops = sum(n * conv.step_flops(s["image_size"], s["batch"], kind)
                for kind, n in s["timed"]["kinds"].items())
    return 100.0 * flops / (s["timed"]["window_s"] * peaks.PEAK_FLOPS[s["math"]])
