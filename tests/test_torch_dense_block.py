"""PyTorch port, DenseNet's dense blocks in evaluation
(``ops/dense_block.py``, ``models/densenet.py``): on the CPU each plain
version against the unfused PyTorch expression it replaces, on a channel
prefix of a wider buffer; the wrappers' checks and vector widths; the
buffered forward against the concatenating one at SMALL, registry DenseNet
and DenseCPD widths; which path each mode takes (the JAX package's DenseNet
at registry widths is in ``tests/test_torch_models.py``). On the card
(``-m cuda``), each kernel against its plain version, bit for bit, at the
main path's shapes, and DenseCPD's forward through the kernels."""
import functools

import pytest
import torch
import torch.nn.functional as F

from timed_design_tpu_torch.models import MODEL_REGISTRY, quantized_convs
from timed_design_tpu_torch.models.densenet import DenseNet3D
from timed_design_tpu_torch.ops import dense_block
from timed_design_tpu_torch.utils import timing

SMALL = {"growth_rate": 4, "block_layers": (2, 2, 2), "init_features": 8}
DENSENET = {"growth_rate": 12, "block_layers": (4, 4, 4), "init_features": 24}
ZOO = {"growth_rate": 16, "block_layers": (6, 6, 6), "init_features": 32}
# the closeness of two roundings of one float32 value to bfloat16: 1 ulp
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


def _bn_params(c: int, g: torch.Generator, device="cpu"):
    """(mean, var, weight, bias) of a BatchNorm over ``c`` channels."""
    def u(lo, hi):
        return (torch.rand(c, generator=g) * (hi - lo) + lo).to(device)

    return u(-0.5, 0.5), u(0.2, 3.0), u(0.5, 1.5), u(-0.3, 0.3)


def _buffer(shape, dtype, g: torch.Generator, device="cpu") -> torch.Tensor:
    return torch.randn(shape, generator=g).to(dtype).to(device)


def _unfused_bn_relu(x, channels, mean, var, weight, bias, conv_bias=None, out_dtype=None):
    """What the concatenating path runs: the prefix to float32, the
    convolution's bias, BatchNorm in evaluation mode, ReLU, the cast back."""
    v = x[..., :channels].float().permute(0, 4, 1, 2, 3)
    if conv_bias is not None:
        v = v + conv_bias.view(-1, 1, 1, 1)
    y = F.relu(F.batch_norm(v, mean, var, weight, bias, False, 0.0, 1e-3))
    return y.permute(0, 2, 3, 4, 1).to(out_dtype or x.dtype)


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    """Two float32 roundings of the same value apart: 2 ulp in float32, 1 in
    bfloat16."""
    rtol = BF16_ULP if got.dtype == torch.bfloat16 else 2.0 ** -22
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("channels,total", [(48, 128), (36, 72), (64, 64)])
@pytest.mark.parametrize("with_conv_bias", [False, True], ids=["", "conv_bias"])
def test_bn_relu_plain_equals_the_unfused_expression(dtype, channels, total, with_conv_bias):
    g = torch.Generator().manual_seed(channels + total)
    x = _buffer((2, 5, 4, 3, total), dtype, g)
    params = _bn_params(channels, g)
    cb = torch.randn(channels, generator=g) if with_conv_bias else None
    got = dense_block.bn_relu_plain(x, channels, *params, 1e-3, cb)
    assert got.shape == (2, 5, 4, 3, channels) and got.dtype == dtype and got.is_contiguous()
    _close(got, _unfused_bn_relu(x, channels, *params, cb))


def test_bn_relu_plain_writes_float32_from_bfloat16():
    """The head's BatchNorm-ReLU: a bfloat16 buffer in, float32 out, the
    concatenating path's ``F.relu(bn(x.float()))`` exactly up to rounding."""
    g = torch.Generator().manual_seed(3)
    x = _buffer((3, 5, 5, 5, 176), torch.bfloat16, g)
    params = _bn_params(176, g)
    got = dense_block.bn_relu_plain(x, 176, *params, 1e-3, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, _unfused_bn_relu(x, 176, *params, out_dtype=torch.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("channel,N,total", [(0, 32, 128), (112, 16, 128), (36, 12, 72)])
def test_bias_store_plain_writes_its_slice_alone(dtype, channel, N, total):
    """The stored slice is ``cat``'s: the convolution's output plus its bias
    in float32, rounded; every other channel of the buffer is left as it
    was."""
    g = torch.Generator().manual_seed(N + channel)
    buf = _buffer((2, 4, 3, 5, total), dtype, g)
    before = buf.clone()
    h = _buffer((2, 4, 3, 5, N), dtype, g)
    b = torch.randn(N, generator=g)
    dense_block.bias_store_plain(h, b, buf, channel)
    torch.testing.assert_close(buf[..., channel:channel + N], (h.float() + b).to(dtype),
                               rtol=0, atol=0)
    keep = torch.ones(total, dtype=torch.bool)
    keep[channel:channel + N] = False
    assert torch.equal(buf[..., keep], before[..., keep])
    dense_block.bias_store_plain(h, None, buf, channel)
    assert torch.equal(buf[..., channel:channel + N], h)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("edge,N,total", [(21, 64, 160), (10, 40, 88), (5, 36, 72)])
def test_pool_bias_store_plain_is_the_average_pool(dtype, edge, N, total):
    """The transition's pooling as the concatenating path runs it
    (``F.avg_pool3d`` in float32, odd edges floored), plus the bias, into the
    first channels of the next block's buffer."""
    g = torch.Generator().manual_seed(edge + N)
    h = _buffer((2, edge, edge, edge, N), dtype, g)
    b = torch.randn(N, generator=g)
    half = edge // 2
    out = torch.full((2, half, half, half, total), 7.0, dtype=dtype)
    dense_block.pool_bias_store_plain(h, b, out, 0)
    want = F.avg_pool3d(h.float().permute(0, 4, 1, 2, 3), 2, 2).permute(0, 2, 3, 4, 1) + b
    _close(out[..., :N], want.to(dtype))
    assert (out[..., N:] == 7.0).all()


def test_wrappers_take_the_plain_versions_on_the_cpu():
    g = torch.Generator().manual_seed(11)
    x = _buffer((2, 5, 5, 5, 72), torch.bfloat16, g)
    params = _bn_params(36, g)
    cb = torch.randn(36, generator=g)
    launches = (dense_block.bn_relu.launches, dense_block.bias_store.launches,
                dense_block.pool_bias_store.launches)
    assert torch.equal(dense_block.bn_relu(x, 36, *params, 1e-3, cb),
                       dense_block.bn_relu_plain(x, 36, *params, 1e-3, cb))
    h = _buffer((2, 5, 5, 5, 12), torch.bfloat16, g)
    got, want = x.clone(), x.clone()
    dense_block.bias_store(h, cb[:12], got, 36)
    dense_block.bias_store_plain(h, cb[:12], want, 36)
    assert torch.equal(got, want)
    got = torch.zeros(2, 2, 2, 2, 20, dtype=torch.bfloat16)
    want = torch.ones_like(got)
    dense_block.pool_bias_store(h, None, got, 4)
    dense_block.pool_bias_store_plain(h, None, want, 4)
    assert torch.equal(got[..., 4:16], want[..., 4:16])
    assert (dense_block.bn_relu.launches, dense_block.bias_store.launches,
            dense_block.pool_bias_store.launches) == launches


def test_wrappers_refuse_what_the_kernels_do_not_take():
    g = torch.Generator().manual_seed(12)
    x = _buffer((1, 3, 3, 3, 16), torch.bfloat16, g)
    params = _bn_params(8, g)
    with pytest.raises(ValueError, match="must be"):
        dense_block.bn_relu(x.half(), 8, *params, 1e-3)
    with pytest.raises(ValueError, match="channels"):
        dense_block.bn_relu(x, 17, *_bn_params(17, g), 1e-3)
    with pytest.raises(ValueError, match="per-channel"):
        dense_block.bn_relu(x, 8, *_bn_params(16, g), 1e-3)
    with pytest.raises(ValueError, match="out_dtype"):
        dense_block.bn_relu(x, 8, *params, 1e-3, out_dtype=torch.float16)
    h = _buffer((1, 3, 3, 3, 8), torch.bfloat16, g)
    with pytest.raises(ValueError, match="buffer"):
        dense_block.bias_store(h, None, x, 9)  # channels 9..16 past the buffer
    with pytest.raises(ValueError, match="buffer"):
        dense_block.bias_store(h, None, x.float(), 0)
    with pytest.raises(ValueError, match="buffer"):
        dense_block.pool_bias_store(h, None, x, 0)  # the buffer is not pooled


@pytest.mark.parametrize("elt,counts,pointers,want", [
    (2, (48, 128), (0, 4096), 8),
    (2, (36, 72), (0, 4096), 4),  # DenseNet's growth of 12
    (4, (48, 128), (0, 4096), 4),  # float32: 16 bytes a load
    (2, (18, 30), (0, 4096), 2),
    (2, (16, 128), (0, 4096 + 36 * 2), 4),  # a slice starting at channel 36
    (4, (5,), (0,), 1),
])
def test_the_vector_width_follows_the_shapes(elt, counts, pointers, want):
    assert dense_block._vector(elt, counts, pointers) == want


def _module(widths: dict, dtype=torch.float32, seed: int = 0) -> DenseNet3D:
    """A module of ``widths`` with seeded weights and BatchNorm statistics."""
    torch.manual_seed(seed)
    m = DenseNet3D(compute_dtype=dtype, **widths)
    g = torch.Generator().manual_seed(seed)
    for bn in m.modules():
        if isinstance(bn, torch.nn.BatchNorm3d):
            mean, var, weight, bias = _bn_params(bn.num_features, g)
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
            with torch.no_grad():
                bn.weight.copy_(weight)
                bn.bias.copy_(bias)
    return m.eval()


@functools.lru_cache(maxsize=None)
def _frames(n: int, seed: int = 1) -> torch.Tensor:
    return torch.rand(n, 21, 21, 21, 5, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("widths", [SMALL, DENSENET, ZOO], ids=["small", "densenet", "zoo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_buffered_forward_equals_the_concatenated_one(widths, dtype):
    """The same module with autograd on (concatenating) and under
    ``inference_mode`` (block buffers): float32 logits within 1e-5; in
    bfloat16 the buffers round the convolutions' biases in float32, not
    bfloat16, so the logits move, by less than one bfloat16 step of the
    largest (4.5e-4 of it seen), and the argmax stays."""
    m = _module(widths, dtype)
    x = _frames(3)
    want = m(x, logits=True).detach()
    with torch.inference_mode():
        got = m(x, logits=True)
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 1e-5
    else:
        assert (got - want).abs().max() <= BF16_ULP * want.abs().max()
        assert torch.equal(got.argmax(1), want.argmax(1))


def _engaged(module, x, grad: bool) -> dict:
    with timing.recording() as rec, torch.set_grad_enabled(grad):
        module(x)
    return {k: v for k, v in rec.counters.items() if k.startswith("densenet.bn_relu")}


@pytest.mark.parametrize("case", ["eval", "eval_bf16", "train", "grad", "float64"])
def test_each_path_engages_by_what_it_observes(case):
    """Evaluation without autograd in bfloat16 or float32 fills block
    buffers; training, autograd on or a float64 module concatenate."""
    dtype = {"eval_bf16": torch.bfloat16, "float64": torch.float64}.get(case, torch.float32)
    m = _module(SMALL, dtype).to(dtype if case == "float64" else torch.float32)
    m.train(case == "train")
    got = _engaged(m, _frames(2), grad=case in ("train", "grad"))
    fused = case in ("eval", "eval_bf16")
    assert got == {f"densenet.bn_relu.{'fused' if fused else 'plain'}": 15}


@pytest.mark.parametrize("mode", ["int8", "int8-fake", "w8"])
def test_quantized_convolutions_keep_their_bias(mode):
    """Under a quantize mode the bias still reaches the output: the block
    buffers' convolutions run without it and the pass after each adds it,
    where the concatenating path keeps it in the convolution; the same
    logits."""
    m = _module(SMALL, seed=4)
    x = _frames(2, seed=2)
    with quantized_convs(mode):
        want = m(x, logits=True).detach()
        with torch.inference_mode():
            got = m(x, logits=True)
    assert (got - want).abs().max() <= 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# (kernel, dtype, batch, edge, channels, buffer width, channel slice) at the
# main path's shapes: DenseCPD's block 0 at batch 512 (a prefix of 48 of
# 128), its bottleneck (64 with the 1^3 convolution's bias), a transition's
# pooling into block 1 and the head; registry DenseNet's rows of 36 of 72
CARD_CASES = [
    ("bn_relu", torch.bfloat16, 512, 21, 48, 128, None),
    ("bn_relu_bias", torch.bfloat16, 64, 21, 64, 64, None),
    ("bn_relu", torch.bfloat16, 64, 10, 36, 72, None),
    ("bn_relu", torch.float32, 64, 21, 48, 128, None),
    ("bn_relu_bias", torch.float32, 64, 10, 36, 72, None),
    ("head", torch.bfloat16, 512, 5, 176, 176, None),
    ("bias_store", torch.bfloat16, 512, 21, 16, 128, 112),
    ("bias_store", torch.bfloat16, 64, 21, 32, 128, 0),
    ("bias_store", torch.bfloat16, 64, 10, 12, 72, 36),
    ("bias_store", torch.float32, 64, 21, 16, 128, 48),
    ("pool", torch.bfloat16, 512, 21, 64, 160, 0),
    ("pool", torch.float32, 64, 21, 36, 72, 0),
    ("pool", torch.bfloat16, 64, 10, 40, 88, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: f"{c[0]}-{str(c[1])[6:]}-"
                         f"{c[2]}x{c[3]}-{c[4]}of{c[5]}")
def test_kernels_equal_their_plain_versions_on_the_card(cuda_device, case):
    """Each kernel against its plain version run on the card: the same bits
    (float32 steps each rounded on its own on both sides), and a store
    touches its slice alone."""
    kind, dtype, B, edge, C, total, channel = case
    g = torch.Generator().manual_seed(B + edge + C)
    dev = cuda_device
    gd = torch.Generator(device=dev).manual_seed(B + edge + C)

    def randn(*shape):
        return torch.randn(shape, generator=gd, device=dev).to(dtype)

    if kind in ("bn_relu", "bn_relu_bias", "head"):
        x = randn(B, edge, edge, edge, total)
        params = _bn_params(C, g, dev)
        cb = torch.randn(C, generator=g).to(dev) if kind == "bn_relu_bias" else None
        out_dtype = torch.float32 if kind == "head" else None
        before = dense_block.bn_relu.launches
        got = dense_block.bn_relu(x, C, *params, 1e-3, cb, out_dtype)
        want = dense_block.bn_relu_plain(x, C, *params, 1e-3, cb, out_dtype)
        assert dense_block.bn_relu.launches == before + 1
    else:
        pool = kind == "pool"
        h = randn(B, edge, edge, edge, C)
        b = torch.randn(C, generator=g).to(dev)
        e = edge // 2 if pool else edge
        got = randn(B, e, e, e, total)
        want = got.clone()
        if pool:
            dense_block.pool_bias_store(h, b, got, channel)
            dense_block.pool_bias_store_plain(h, b, want, channel)
        else:
            dense_block.bias_store(h, b, got, channel)
            dense_block.bias_store_plain(h, b, want, channel)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_densecpd_forward_launches_each_kernel(cuda_device):
    """One bfloat16 forward of DenseCPD at the zoo's widths under
    ``inference_mode``: 39 BatchNorm-ReLUs, 19 stores (the stem and 18
    layers) and 2 pools through the kernels, and the logits of the
    concatenating path on the card, within one bfloat16 step of the
    largest."""
    module = MODEL_REGISTRY["DenseCPD"].build(compute_dtype=torch.bfloat16).to(cuda_device)
    x = torch.rand(8, 21, 21, 21, 5, device=cuda_device)
    module.eval()
    want = module(x, logits=True).detach()
    counts = (dense_block.bn_relu.launches, dense_block.bias_store.launches,
              dense_block.pool_bias_store.launches)
    with torch.inference_mode():
        got = module(x, logits=True)
    assert (dense_block.bn_relu.launches, dense_block.bias_store.launches,
            dense_block.pool_bias_store.launches) == (counts[0] + 39, counts[1] + 19,
                                                      counts[2] + 2)
    assert (got - want).abs().max() <= BF16_ULP * want.abs().max()
