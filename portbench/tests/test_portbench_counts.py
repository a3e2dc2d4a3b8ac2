"""The frozen counts against the program's own: the conv flops of each step
kind equal ``tools/roofline.py``'s at 64px and 512px, the reference's
leaves the port's parameters, and the bound arithmetic ``tools/timing``'s."""

from __future__ import annotations

import pytest
import torch

from tiny import ROOT  # noqa: F401  (puts the repository on the path)

from portbench.counts import conv, peaks
from portbench.reference import discogan as ref


@pytest.mark.parametrize("size,batch", [(64, 64), (512, 32), (512, 8)])
@pytest.mark.parametrize("kind", ["gen", "dis", "lean"])
def test_conv_flops_equal_the_roofline_tool(size, batch, kind):
    from discogan_modernized_torch.tools.roofline import step_counts

    assert conv.step_flops(size, batch, kind) == step_counts(size, batch, 2, "mv", kind)["flops"]


def test_the_bytes_of_each_op_equal_step_itemize():
    from discogan_modernized_torch.tools import step_itemize as si

    for rows, mine in ((si._gen_layers(512), conv.gen_layers(512)),
                       (si._dis_layers(512), conv.dis_layers(512))):
        for (_, op, size, cin, cout, _), (_, op2, size2, cin2, cout2) in zip(rows, mine,
                                                                             strict=True):
            assert (op, size, cin, cout) == (op2, size2, cin2, cout2)
            b = si.layer_io_bytes(op, size, cin, cout, 32, 2)
            assert b["fwd"] == b["dx"] == b["dw"] == conv.layer_bytes(op, size, cin, cout, 32, 2)


def test_peaks_equal_the_program_bounds():
    from discogan_modernized_torch.tools.timing import HBM_BYTES_PER_S, PEAK_FLOPS

    assert peaks.PEAK_FLOPS["bf16"] == PEAK_FLOPS[torch.bfloat16]
    assert peaks.PEAK_FLOPS["f32"] == PEAK_FLOPS[torch.float32]
    assert peaks.HBM_BYTES_PER_S == HBM_BYTES_PER_S


@pytest.mark.parametrize("size", [16, 64, 512])
def test_reference_leaves_are_the_port_parameters(size):
    from discogan_modernized_torch.models.discriminator import Discriminator
    from discogan_modernized_torch.models.generator import Generator

    specs = ref.leaf_specs(size)
    with torch.device("meta"):
        nets = {"gen_A": Generator(size), "dis_A": Discriminator(size)}
    for net, module in nets.items():
        assert [tuple(p.shape) for p in module.parameters()] == [s[1] for s in specs[net]]


def test_the_512px_parameter_counts():
    specs = ref.leaf_specs(512)
    assert sum(torch.Size(s[1]).numel() for s in specs["gen_A"]) == 230_192_968
    assert sum(torch.Size(s[1]).numel() for s in specs["dis_A"]) == 111_852_288
