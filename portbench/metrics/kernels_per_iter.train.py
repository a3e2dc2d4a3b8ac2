"""Device kernels (copies and fills left out) per trainer iteration, in
the traced sub-window."""


def read(s: dict):
    if s["device_type"] != "cuda" or not s["kernel_count"] or not s["iterations"]:
        return None
    return s["kernel_count"] / s["iterations"]
