"""Device ms per trainer iteration of PyTorch's own kernels (class
``elementwise``: Adam, the weight casts, BN/activation backward, losses,
gathers), in the traced sub-window."""


def read(s: dict):
    t = s["classes"].get("elementwise")
    if s["device_type"] != "cuda" or not t or not s["iterations"]:
        return None
    return 1e3 * t / s["iterations"]
