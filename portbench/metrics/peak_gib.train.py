"""``torch.cuda.max_memory_allocated()`` over set-up and the timed window,
the dataset included, in GiB."""


def read(s: dict):
    if s["device_type"] != "cuda" or not s["peak_bytes"]:
        return None
    return s["peak_bytes"] / 2 ** 30
