"""The least time the card could take for all conv, convT, dx and dw work
of the traced sub-window's iterations (counts/conv.py: each op's larger of
flops over the math type's peak and bytes over the HBM bandwidth, summed),
over the device time of the kernels that do that work, the port's and the
library's alike (classes ``port_conv`` and ``library``), in %."""

from portbench.counts import conv, peaks


def read(s: dict):
    t = s["classes"].get("port_conv", 0.0) + s["classes"].get("library", 0.0)
    if s["device_type"] != "cuda" or not t or not s["iterations"]:
        return None
    least = sum(n * conv.step_least_seconds(s["image_size"], s["batch"], s["itemsize"], kind,
                                            peaks.PEAK_FLOPS[s["math"]], peaks.HBM_BYTES_PER_S)
                for kind, n in s["kinds"].items())
    return 100.0 * least / t
