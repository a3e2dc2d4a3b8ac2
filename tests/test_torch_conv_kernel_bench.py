"""``tools/conv_kernel_bench.py``'s rows on the CPU: ``bench_layer`` called
directly, so through the plain versions, with a stub timer. Where the
generator's route takes a layer to K5f (``takes_halo``) the row carries
K5f's columns beside K3's, and nowhere else."""

import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

from discogan_modernized_torch.tools import conv_kernel_bench


class _StubTimer:
    """Calls the function once and answers a fixed time (ms)."""

    def __init__(self):
        self.calls = 0

    def ms(self, fn):
        fn()
        self.calls += 1
        return 2.0


@pytest.mark.parametrize("n,s,ci,co,halo", [
    (1, 128, 8, 16, True),     # 128 wide, 8 channels: K5f's route
    (2, 64, 8, 16, False),     # narrower than 128: K3's
    (1, 128, 128, 16, False),  # more than 64 channels: K3's
])
def test_bench_layer_times_k5f_where_the_route_takes_it(n, s, ci, co, halo):
    timer = _StubTimer()
    row = conv_kernel_bench.bench_layer(n, s, ci, co, torch.float32, timer, "cpu")
    assert row["layer"] == f"{s}px {ci}->{co}" and row["kernel_us"] == 2000.0
    halo_keys = {"halo_kernel_us", "halo_tf", "halo_ratio"}
    if halo:
        assert halo_keys <= set(row) and row["halo_ratio"] == 1.0
        assert row["halo_kernel_us"] == 2000.0 and timer.calls == 3
    else:
        assert not halo_keys & set(row) and timer.calls == 2


@pytest.mark.parametrize("n,s,ci,co,halo", [
    (1, 16, 3, 8, False),      # the stem's 3 channels
    (2, 16, 16, 24, False),    # K4 alone
    (1, 128, 8, 16, True),     # K5f's route: K5b beside K4
])
def test_bench_layer_dw_rows_carry_the_bound(n, s, ci, co, halo):
    """``--dw``'s rows: K4 (and K5b where the route takes the layer to K5f)
    against the library's time, beside the bound of the weight gradient
    (flops 2 x MACs over f32's peak, bytes of x, dy and dw once over the
    memory rate) and the kernel's share of it."""
    from discogan_modernized_torch.tools.timing import bound_ms

    timer = _StubTimer()
    row = conv_kernel_bench.bench_layer(n, s, ci, co, torch.float32, timer, "cpu", dw=True)
    m = n * (s // 2) ** 2
    want, by = bound_ms(2 * m * 16 * ci * co, (n * s * s * ci + m * co + 16 * ci * co) * 4,
                        torch.float32)
    assert row["dw_kernel_us"] == row["dw_library_us"] == 2000.0 and row["dw_ratio"] == 1.0
    assert row["dw_bound_us"] == pytest.approx(want * 1e3) and row["dw_bound_by"] == by
    assert row["dw_kernel_share"] == pytest.approx(want * 1e3 / 2000.0)
    assert ("dw_halo_share" in row) == halo
    if halo:
        assert row["dw_halo_share"] == pytest.approx(want * 1e3 / 2000.0)
    assert timer.calls == 4 + 2 * halo
