"""The optimizer's multi-tensor kernel (csrc/adam.cu) against
``Adam._apply_plain``, on the card, bit for bit.

Marked ``gpu``: they skip where CUDA is not available. On a machine with
the card (and without JAX, which tests/conftest.py imports), run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_adam_kernel.py

Two optimizers from the same state take five steps on the same gradients
and device scalars, one through ``apply`` (the kernel), one through the
plain loop; p, m and v must be equal (``torch.equal``) under each slim
state: f32 moments ("off"), bf16 moments ("mv"), bf16 masters with
stochastic rounding ("all"). Shapes: the 64px generator's and
discriminator's parameters, odd sizes, tensors larger than a chunk, more
tensors than one argument block holds; gradients as views at unaligned
offsets of one flat buffer (data parallelism), parameters at unaligned
offsets (a scalar head), a slice of a whole tensor (a mesh), conv
weights' gradients in their permuted views' order, as a 64px train step's
autograd leaves them; a launch
captured in a CUDA graph and replayed with new bias corrections and seeds
from a strided table, as the chunked trainer gives them.
"""

import pytest
import torch

from discogan_modernized_torch.ops import _build
from discogan_modernized_torch.ops.adam import CHUNK, MAX_TENSORS

pytestmark = pytest.mark.gpu
F32, BF16 = torch.float32, torch.bfloat16
MODES = {"off": (F32, F32), "mv": (F32, BF16), "all": (BF16, BF16)}
ODD = [(1,), (3,), (7,), (9,), (13,), (65,), (1023,), (4097,), (30001,), (5, 7, 3)]
LARGE = [(3 * CHUNK + 5,), (512, 512, 4, 4), (CHUNK,)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _shapes(size: int) -> tuple[list, list]:
    from discogan_modernized_torch.models.discriminator import Discriminator
    from discogan_modernized_torch.models.generator import Generator

    with torch.device("meta"):
        return ([tuple(p.shape) for p in Generator(size).parameters()],
                [tuple(p.shape) for p in Discriminator(size).parameters()])


def _pair(shapes, mode, device, wd=1e-5, param_offset=None):
    """Two optimizers over equal parameters of ``shapes`` (``param_offset``:
    the parameters as views of one flat buffer, that many elements in)."""
    from discogan_modernized_torch.train.optim import Adam

    p_dtype, mv = MODES[mode]
    gen = torch.Generator(device).manual_seed(0)
    out = []
    for _ in range(2):
        gen.manual_seed(0)
        if param_offset is None:
            params = [torch.randn(s, generator=gen, device=device).to(p_dtype) for s in shapes]
        else:
            sizes = [torch.Size(s).numel() for s in shapes]
            flat = torch.randn(param_offset + sum(sizes), generator=gen, device=device)
            flat = flat.to(p_dtype)[param_offset:]
            params = [t.view(s) for t, s in zip(flat.split(sizes), shapes)]
        out.append(Adam(params, lr=2e-4, beta1=0.5, beta2=0.999, weight_decay=wd,
                        mv_dtype=mv))
    return out


def _grads(opt, step, grad_offset=None, orders=None):
    """Gradients of ``opt``'s parameters: contiguous; views at
    ``grad_offset`` of one flat buffer; or, for the 4-D ones, laid out in
    memory in ``orders[i]`` (a permutation of the dims: a conv weight's
    gradient from its permuted view, models/regions.py::materialize)."""
    gen = torch.Generator(opt.params[0].device).manual_seed(100 + step)
    dtype = opt.params[0].dtype
    if orders is not None:
        out = []
        for p, order in zip(opt.params, orders):
            shape = [p.shape[d] for d in order]
            g = (torch.randn(shape, generator=gen, device=p.device) * 0.05).to(dtype)
            out.append(g.permute(sorted(range(len(order)), key=order.__getitem__)))
        return out
    if grad_offset is None:
        return [(torch.randn(p.shape, generator=gen, device=p.device) * 0.05).to(dtype)
                for p in opt.params]
    sizes = [p.numel() for p in opt.params]
    flat = torch.randn(grad_offset + sum(sizes), generator=gen, device=opt.params[0].device)
    flat = (flat * 0.05).to(dtype)[grad_offset:]
    return [t.view(p.shape) for t, p in zip(flat.split(sizes), opt.params)]


def _scalars(opt, step):
    bc1, bc2, seeds = opt.step_scalars(step)
    device = opt.params[0].device
    return (torch.tensor([bc1, bc2], device=device),
            torch.tensor(seeds, dtype=torch.int32, device=device))


def _equal(a, b, where):
    torch.cuda.synchronize()
    for name in ("params", "m", "v"):
        for i, (x, y) in enumerate(zip(getattr(a, name), getattr(b, name))):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{where}: {name}[{i}]"


def _run(shapes, mode, device, steps=5, grad_offset=None, param_offset=None, wd=1e-5,
         shards=None, orders=None):
    kernel, plain = _pair(shapes, mode, device, wd, param_offset)
    if shards:
        for i, shard in shards.items():
            kernel.shards[i] = plain.shards[i] = shard
    before = _build.launches["adam"]
    for step in range(1, steps + 1):
        grads = _grads(kernel, step, grad_offset, orders)
        bc, seeds = _scalars(kernel, step)
        kernel.apply(grads, bc, seeds)
        plain._apply_plain(grads, bc, seeds)
        _equal(kernel, plain, f"{mode} step {step}")
    return _build.launches["adam"] - before


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("net", ["gen", "dis"])
def test_64px_shapes(cuda, mode, net):
    gen, dis = _shapes(64)
    shapes = gen if net == "gen" else dis
    assert _run(shapes, mode, cuda) == 5  # one launch a step


@pytest.mark.parametrize("mode", MODES)
def test_no_weight_decay(cuda, mode):
    _run(_shapes(64)[1], mode, cuda, wd=0.0)


@pytest.mark.parametrize("mode", MODES)
def test_odd_and_large_sizes(cuda, mode):
    _run(ODD + LARGE, mode, cuda)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grad_offset", [1, 3, 5])
def test_gradients_as_unaligned_views(cuda, mode, grad_offset):
    _run(ODD + _shapes(64)[1], mode, cuda, grad_offset=grad_offset)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("param_offset", [1, 6])
def test_parameters_at_unaligned_offsets(cuda, mode, param_offset):
    _run(ODD + LARGE, mode, cuda, param_offset=param_offset, grad_offset=2)


@pytest.mark.parametrize("mode", MODES)
def test_second_launch(cuda, mode):
    shapes = [(13,), (64, 3, 4, 4)] * (MAX_TENSORS // 2 + 3)
    assert _run(shapes, mode, cuda, steps=2) == 2 * 2


# The conv weights' gradients: (shape, the order of its dims in memory).
GATHERED = [((64, 3, 4, 4), (2, 3, 1, 0)), ((256, 128, 4, 4), (2, 3, 1, 0)),
            ((1, 512, 4, 4), (2, 3, 1, 0)), ((512, 256, 4, 4), (0, 2, 3, 1)),
            ((100, 128, 4, 4), (0, 2, 3, 1)), ((64, 3, 4, 4), (2, 3, 0, 1)), ((64,), (0,)),
            ((13,), (0,))]


@pytest.mark.parametrize("mode", MODES)
def test_gradients_in_the_views_order(cuda, mode):
    shapes, orders = zip(*GATHERED)
    _run(list(shapes), mode, cuda, orders=list(orders))


@pytest.mark.parametrize("mode", MODES)
def test_64px_train_step_gradients(cuda, mode):
    """The gradients of one D and one G step of the 64px train graph (batch
    4), as autograd leaves them: every tensor through the kernel, one launch
    an optimizer, the plain loop's bits."""
    import copy

    from discogan_modernized_torch.core.precision import default_policy
    from discogan_modernized_torch.train.step import (TrainConfig, init_train_state,
                                                      loss_and_grads)

    cfg = TrainConfig(image_size=64, precision="bf16", slim_state=mode)
    ts = init_train_state(0, cfg, cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    A, B = torch.rand(2, 4, 64, 64, 3, generator=gen, device=cuda)
    for which in ("dis", "gen"):
        opt = ts.opt_gen if which == "gen" else ts.opt_dis
        _, grads = loss_and_grads(ts, A, B, torch.tensor(0.9, device=cuda), cfg,
                                  default_policy("bf16"), which)
        assert any(not g.is_contiguous() for g in grads)
        plain = copy.deepcopy(opt)
        bc, seeds = _scalars(opt, 1)
        before = _build.launches["adam"]
        opt.apply(grads, bc, seeds)
        plain._apply_plain(grads, bc, seeds)
        assert _build.launches["adam"] - before == 1
        _equal(opt, plain, f"{mode} {which} step")


def test_a_tensor_the_kernel_does_not_take_raises(cuda):
    """A parameter that is a transposed view: a ValueError that names it,
    and no tensor changed."""
    kernel, plain = _pair([(13,), (24, 40)], "mv", cuda)
    kernel.params[1] = kernel.params[1].view(40, 24).t()
    plain.params[1] = plain.params[1].view(40, 24).t()
    grads = _grads(kernel, 1)
    bc, seeds = _scalars(kernel, 1)
    before = _build.launches["adam"]
    with pytest.raises(ValueError, match=r"tensor 1 \(24, 40\): p is not contiguous"):
        kernel.apply(grads, bc, seeds)
    assert _build.launches["adam"] == before
    _equal(kernel, plain, "after the refusal")


def test_slices_of_whole_tensors(cuda):
    """bf16 masters split over a mesh's model axis draw their elements'
    bits of the whole tensor."""
    shapes = [(8, 4, 4, 96), (40, 27), (128,)]
    shards = {0: ((8, 4, 4, 256), 3, 128), 1: ((80, 27), 0, 40), 2: ((512,), 0, 256)}
    _run(shapes, "all", cuda, shards=shards)


@pytest.mark.parametrize("mode", MODES)
def test_graph_replay(cuda, mode):
    """One apply captured with its scalars read from a strided int64 table
    (train/chunk.py's layout) and replayed five times with new rows, against
    eager launches and the plain loop."""
    shapes = _shapes(64)[1] + ODD
    kernel, plain = _pair(shapes, mode, cuda)
    eager, _ = _pair(shapes, mode, cuda)
    n = len(shapes)
    table = torch.zeros(3 + n, dtype=torch.int64, device=cuda)
    bc = table[:3].view(torch.float32)[0::2][1:]      # (rate, bc1, bc2) words, stride 2
    seeds = table[3:].view(torch.int32)[0::2]
    grads = [torch.zeros_like(p) for p in kernel.params]
    _build.library()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kernel.apply(grads, bc, seeds)
    for step in range(1, 6):
        for g, new in zip(grads, _grads(kernel, step)):
            g.copy_(new)
        bc1, bc2, words = kernel.step_scalars(step)
        row = torch.zeros(3 + n, dtype=torch.int64)
        row[:3].view(torch.float32)[0::2] = torch.tensor([0.0, bc1, bc2])
        row[3:].view(torch.int32)[0::2] = torch.tensor(words, dtype=torch.int32)
        table.copy_(row)
        graph.replay()
        eager_bc, eager_seeds = _scalars(eager, step)
        eager.apply(grads, eager_bc, eager_seeds)
        plain._apply_plain(grads, eager_bc, eager_seeds)
        _equal(kernel, eager, f"{mode} replay {step} against eager")
        _equal(kernel, plain, f"{mode} replay {step} against plain")
