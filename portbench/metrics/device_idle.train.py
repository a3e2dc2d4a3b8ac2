"""Share of the traced sub-window in which no kernel and no copy runs on
the device, in %."""


def read(s: dict):
    if s["device_type"] != "cuda" or not s["window_s"] or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
