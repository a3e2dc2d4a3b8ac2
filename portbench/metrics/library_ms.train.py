"""Device ms per trainer iteration of cuDNN's and cuBLAS's kernels with
their layout transforms (class ``library``), in the traced sub-window."""


def read(s: dict):
    t = s["classes"].get("library")
    if s["device_type"] != "cuda" or not t or not s["iterations"]:
        return None
    return 1e3 * t / s["iterations"]
