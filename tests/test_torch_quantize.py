"""PyTorch port, quantized inference: ``models/quantize.py`` and the int8
convolution ``ops/conv3d_int8.py`` against the JAX package's
``models/quantize.py`` on the same inputs.

Inputs and weights are made with numpy from a seed (weights by the Flax
modules' init, carried across by the port's converters) and given to both
packages. Tolerances:
  - the int8 convolution's int32 sums: exact, against an int64 numpy
    convolution and against JAX's ``preferred_element_type=int32``
    convolution on the same codes;
  - one quantized convolution: float32 1e-5 (the pin of
    ``tests/test_quantize.py``), bfloat16 1e-2 (``test_torch_models.py``:
    the frameworks round at other places);
  - whole forwards on 1ubq's 76 frames, float32: argmax agreement 1.0 and
    probabilities within 1e-5. The two frameworks sum the float32
    convolutions in another order, so an activation whose code sits at a
    rounding tie can take the next code in one of them; the test counts the
    codes that differ;
  - the JAX package's own pins (``tests/test_quantize.py``): against the
    unquantized forward, argmax agreement >= 0.95 and |dp| < 2e-3; rows sum
    to 1 within 1e-4.
JAX's int8 convolutions are emulated on the CPU (a full-width TIMED took
252 s against 14 s, ``tests/test_quantize.py``), so the models are narrow:
TIMED with filters (8, 16), ProDCoNN, and DenseNet with two blocks of two
layers.
"""
import functools
import threading

import numpy as np
import pytest
import torch

MODES = ("w8", "int8-fake", "int8")
FAMILIES = ("TIMED", "ProDCoNN", "DenseNet")
DENSENET = {"growth_rate": 4, "block_layers": (2, 2), "init_features": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ the int8 convolution

def _numpy_conv_int64(x, w, pad):
    """int64 sums of x (B, D, H, W, C) with w (N, k, k, k, C), stride 1."""
    k = w.shape[1]
    xp = np.pad(x.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (pad, pad), (0, 0)))
    B, D, H, W, _ = xp.shape
    out = np.zeros((B, D - k + 1, H - k + 1, W - k + 1, w.shape[0]), np.int64)
    for dz in range(k):
        for dy in range(k):
            for dx in range(k):
                patch = xp[:, dz:dz + out.shape[1], dy:dy + out.shape[2], dx:dx + out.shape[3]]
                out += np.einsum("bzyxc,nc->bzyxn", patch, w[:, dz, dy, dx].astype(np.int64))
    return out


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("cin", [5, 36])
@pytest.mark.parametrize("k,pad", [(1, 0), (3, 1), (3, 0), (4, 0)],
                         ids=["1_same", "3_same", "3_valid", "4_valid"])
def test_conv3d_int8_plain_is_exact(k, pad, cin, monkeypatch):
    """Exact against int64 numpy, in one chunk of frames and in chunks of
    one frame."""
    import timed_design_tpu_torch.ops.conv3d_int8 as op
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8, conv3d_int8_plain

    x, w = _codes((3, 7, 6, 5, cin), k), _codes((9, k, k, k, cin), 100 + k)
    want = _numpy_conv_int64(x, w, pad)
    got = conv3d_int8_plain(torch.from_numpy(x), torch.from_numpy(w), pad)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(op, "_PLAIN_TAPS", 1)
    np.testing.assert_array_equal(conv3d_int8_plain(torch.from_numpy(x), torch.from_numpy(w),
                                                    pad).numpy(), want)
    launches = conv3d_int8.launches
    np.testing.assert_array_equal(conv3d_int8(torch.from_numpy(x), torch.from_numpy(w), pad),
                                  want)
    assert conv3d_int8.launches == launches  # the CPU runs the plain version


def test_conv3d_int8_refuses_what_the_kernel_does_not_take():
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8

    x, w = torch.zeros((1, 5, 5, 5, 4), dtype=torch.int8), torch.zeros((2, 3, 3, 3, 4),
                                                                        dtype=torch.int8)
    with pytest.raises(ValueError, match="padding"):
        conv3d_int8(x, w, 2)
    with pytest.raises(ValueError, match="padding"):
        conv3d_int8(x, torch.zeros((2, 4, 4, 4, 4), dtype=torch.int8), 1)
    with pytest.raises(ValueError, match="int8"):
        conv3d_int8(x.float(), w)
    with pytest.raises(ValueError, match=r"\(N, k, k, k, 4\)"):
        conv3d_int8(x, torch.zeros((2, 3, 3, 2, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="overflow"):  # 27 * 4932 * 127^2 >= 2^31
        conv3d_int8(torch.zeros((1, 3, 3, 3, 4932), dtype=torch.int8),
                    torch.zeros((1, 3, 3, 3, 4932), dtype=torch.int8))
    assert conv3d_int8(torch.zeros((1, 3, 3, 3, 4931), dtype=torch.int8),
                       torch.zeros((1, 3, 3, 3, 4931), dtype=torch.int8)).shape == (1, 1, 1, 1, 1)


OUT_DTYPES = ("float32", "bfloat16", "float16")
# the ZOO_SHAPES (below) that the CPU's float64 convolution takes in well
# under a second at one frame: the rest differ from these only in size
CPU_ZOO_SHAPES = [(5, 16, 3, 1, 21), (16, 32, 3, 1, 21), (128, 20, 1, 0, 21),
                  (128, 338, 1, 0, 21), (5, 16, 4, 0, 21), (32, 64, 3, 0, 8),
                  (36, 48, 1, 0, 21), (48, 12, 3, 1, 21), (42, 48, 1, 0, 10), (78, 48, 1, 0, 5)]


def _epilogue_inputs(cout, dtype, seed):
    """(N,) float32 scales of the size quantize.py makes (s_x s_w) and an
    (N,) bias in ``dtype``."""
    rng = np.random.default_rng(seed)
    scale = torch.from_numpy((rng.uniform(0.5, 2.0, cout) * 1e-4).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(dtype)
    return scale, bias


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dtype", OUT_DTYPES)
def test_conv3d_int8_fused_plain_equals_composition(dtype, with_bias):
    """The fused function (sums, rescale, cast, bias) equals, bit for bit,
    the PyTorch composition the int8 branch ran before it was fused:
    int32 sums, ``.to(float32).mul_(s)``, NCDHW view, ``.to(dt)``, then
    ``+ bias.view(-1, 1, 1, 1)``; through the wrapper (the CPU runs the
    plain version) and the plain version, at the zoo's shapes on one
    frame."""
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8, conv3d_int8_plain

    dt = getattr(torch, dtype)
    for cin, cout, k, pad, s in CPU_ZOO_SHAPES:
        x = torch.from_numpy(_codes((1, s, s, s, cin), cin))
        w = torch.from_numpy(_codes((cout, k, k, k, cin), cout))
        scale, bias = _epilogue_inputs(cout, dt, cout + k)
        bias = bias if with_bias else None
        acc = conv3d_int8_plain(x, w, pad)
        want = acc.to(torch.float32).mul_(scale).permute(0, 4, 1, 2, 3).to(dt)
        want = (want if bias is None else want + bias.view(-1, 1, 1, 1)).permute(0, 2, 3, 4, 1)
        for got in (conv3d_int8(x, w, pad, scale, bias, dt),
                    conv3d_int8_plain(x, w, pad, scale, bias, dt)):
            assert got.dtype == dt and got.shape == acc.shape
            assert torch.equal(got, want), (cin, cout, k, pad, s)


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dtype", [*OUT_DTYPES, "float64"])
def test_quantized_conv3d_int8_equals_unfused_formula(dtype, with_bias):
    """``quantized_conv3d("int8", ...)`` gives the values of the unfused
    formula bit for bit: int32 sums of the codes, ``.to(float32).mul_(s_x
    s_w)``, ``.to(dt)``, ``+ bias.to(dt)``; float64, which the kernel does
    not write, asks it for float32 and finishes in PyTorch."""
    from timed_design_tpu_torch.models.quantize import (
        quantize_activation, quantize_weight, quantized_conv3d)
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8_plain

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 5, 7, 7, 7)).astype(np.float32)).to(dt)
    w = torch.from_numpy(rng.standard_normal((6, 5, 3, 3, 3)).astype(np.float32)).to(dt)
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32)).to(dt) if with_bias else None
    for padding in (0, 1):
        wq, s_w = quantize_weight(w)
        xq, s_x = quantize_activation(x)
        acc = conv3d_int8_plain(xq.to(torch.int8).permute(0, 2, 3, 4, 1),
                                wq.to(torch.int8).permute(0, 2, 3, 4, 1), padding)
        want = acc.to(torch.float32).mul_(s_x * s_w).permute(0, 4, 1, 2, 3).to(dt)
        want = want if b is None else want + b.to(dt).view(-1, 1, 1, 1)
        got = quantized_conv3d("int8", x, w, b, padding)
        assert got.dtype == dt and got.shape == want.shape
        assert torch.equal(got, want), padding


def test_conv3d_int8_refuses_an_epilogue_it_does_not_write():
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8

    x, w = torch.zeros((1, 5, 5, 5, 4), dtype=torch.int8), torch.zeros((3, 3, 3, 3, 4),
                                                                        dtype=torch.int8)
    s = torch.ones(3)
    with pytest.raises(ValueError, match="scale must be"):
        conv3d_int8(x, w, 1, torch.ones(4))
    with pytest.raises(ValueError, match="scale must be"):
        conv3d_int8(x, w, 1, torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="scale must be"):
        conv3d_int8(x, w, 1, torch.ones(1, 3))
    with pytest.raises(ValueError, match="bias must be"):
        conv3d_int8(x, w, 1, s, torch.zeros(3), torch.bfloat16)
    with pytest.raises(ValueError, match="bias must be"):
        conv3d_int8(x, w, 1, s, torch.zeros(4, dtype=torch.bfloat16), torch.bfloat16)
    with pytest.raises(ValueError, match="out_dtype must be"):
        conv3d_int8(x, w, 1, s, out_dtype=torch.float64)
    with pytest.raises(ValueError, match="out_dtype must be"):
        conv3d_int8(x, w, 1, s, out_dtype=torch.int32)
    with pytest.raises(ValueError, match="needs a scale"):
        conv3d_int8(x, w, 1, bias=torch.zeros(3))
    with pytest.raises(ValueError, match="needs a scale"):
        conv3d_int8(x, w, 1, out_dtype=torch.bfloat16)
    assert conv3d_int8(x, w, 1, out_dtype=torch.int32).dtype == torch.int32
    assert conv3d_int8(x, w, 1, s).dtype == torch.float32
    assert conv3d_int8(x, w, 1, s, torch.zeros(3, dtype=torch.float16),
                       torch.float16).dtype == torch.float16


@pytest.mark.parametrize("cin", [5, 12, 42, 78, 16])
def test_channel_padding_keeps_the_sums(cin):
    """The zero channels the wrapper appends for the kernel's copies (C not
    a multiple of 4: to a multiple of 8) leave every sum as it was."""
    from timed_design_tpu_torch.ops.conv3d_int8 import (
        conv3d_int8_plain, pad_channels, padded_channels)

    x, w = _codes((2, 6, 5, 7, cin), cin), _codes((7, 3, 3, 3, cin), 200 + cin)
    xp, wp = pad_channels(torch.from_numpy(x), torch.from_numpy(w))
    cp = padded_channels(cin)
    assert cp == {5: 8, 12: 12, 42: 48, 78: 80, 16: 16}[cin]
    assert xp.shape[-1] == wp.shape[-1] == cp and xp.dtype == wp.dtype == torch.int8
    assert not xp[..., cin:].any() and not wp[..., cin:].any()
    for pad in (0, 1):
        want = _numpy_conv_int64(x, w, pad)
        np.testing.assert_array_equal(conv3d_int8_plain(xp, wp, pad).numpy(), want)


def test_output_channel_tiles_fit_the_zoo():
    """Each of the zoo's widths gets an instantiated tile width: 20 -> 24,
    the 338-class head two blocks of 176, none wider than 256 channels."""
    from timed_design_tpu_torch.ops.conv3d_int8 import TILE_WIDTHS, tile_n

    got = {n: tile_n(n) for n in (12, 16, 20, 24, 32, 36, 42, 48, 64, 128, 256, 338)}
    assert got[20] == (24, 1) and got[338] == (176, 2) and got[256] == (128, 2)
    assert got[16] == (16, 1) and got[128] == (128, 1) and got[12] == (16, 1)
    for n, (width, blocks) in got.items():
        assert width in TILE_WIDTHS and width * (blocks - 1) < n <= width * blocks, n
        assert blocks <= 2


# ------------------------------------------------- one quantized convolution

def _jax_quantized_conv(mode, x, w, b, padding, dtype):
    """JAX: ``conv_general_dilated`` (NDHWC, DHWIO) under the JAX package's
    gate, then Flax's bias add in ``dtype``."""
    import jax
    import jax.numpy as jnp

    from timed_design_tpu.models.quantize import quantized_convs

    dt = getattr(jnp, dtype)
    with quantized_convs(mode):
        y = jax.lax.conv_general_dilated(
            jnp.asarray(x, dt), jnp.asarray(w, dt), (1, 1, 1), padding,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    return np.asarray((y + jnp.asarray(b, dt)).astype(jnp.float32))


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_quantized_conv3d_matches_jax(mode, dtype, padding):
    from timed_design_tpu_torch.models.quantize import quantized_conv3d

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 7, 7, 7, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5, 6)).astype(np.float32)  # DHWIO
    b = rng.standard_normal(6).astype(np.float32)
    want = _jax_quantized_conv(mode, x, w, b, padding, dtype)
    dt = getattr(torch, dtype)
    got = quantized_conv3d(
        mode, torch.from_numpy(x).to(dt).permute(0, 4, 1, 2, 3),
        torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))).to(dt),
        torch.from_numpy(b).to(dt), 1 if padding == "SAME" else 0)
    assert got.dtype == dt
    got = got.float().permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 if dtype == "float32" else 1e-2, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_codes_and_sums_equal_jax(dtype):
    """The port's weight and activation codes are the JAX gate's (the
    weight cast to the compute dtype first), and the int32 sums of
    ``conv3d_int8`` are JAX's ``preferred_element_type=int32`` convolution's,
    bit for bit."""
    import jax
    import jax.numpy as jnp

    from timed_design_tpu_torch.models.quantize import quantize_activation, quantize_weight
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8

    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, 7, 7, 36)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 36, 12)).astype(np.float32)
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    # the JAX gate's codes (models/quantize.py), on its NDHWC / DHWIO operands
    w32 = jnp.asarray(w, jdt).astype(jnp.float32)
    s_w = jnp.maximum(jnp.max(jnp.abs(w32), axis=(0, 1, 2, 3), keepdims=True) / 127.0,
                      jnp.finfo(jnp.float32).tiny)
    jwq = jnp.clip(jnp.round(w32 / s_w), -127, 127)
    x32 = jnp.asarray(x, jdt).astype(jnp.float32)
    s_x = jnp.maximum(jnp.max(jnp.abs(x32)) / 127.0, jnp.finfo(jnp.float32).tiny)
    jxq = jnp.clip(jnp.round(x32 / s_x), -127, 127)
    want = np.asarray(jax.lax.conv_general_dilated(
        jxq.astype(jnp.int8), jwq.astype(jnp.int8), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"), preferred_element_type=jnp.int32))

    wq, sw = quantize_weight(torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
                             .to(dt))
    xq, sx = quantize_activation(torch.from_numpy(x).to(dt).permute(0, 4, 1, 2, 3))
    np.testing.assert_array_equal(wq.permute(2, 3, 4, 1, 0).numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 4, 1).numpy(), np.asarray(jxq))
    assert float(sx) == float(s_x)
    np.testing.assert_array_equal(sw.numpy(), np.asarray(s_w).ravel())
    got = conv3d_int8(xq.to(torch.int8).permute(0, 2, 3, 4, 1),
                      wq.to(torch.int8).permute(0, 2, 3, 4, 1), 1)
    assert want.dtype == np.int32 and np.abs(want).max() > 2 ** 16
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ whole forwards

@pytest.fixture(scope="module")
def ubq_frames(ubq_pdb_gz):
    """1ubq's 76 frames, voxelized by the JAX package: both packages' input."""
    from timed_design_tpu.structure import load_pdb
    from timed_design_tpu.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    codec = Codec.from_string("CNOCACB")
    fa = structure_to_frame_atoms(load_pdb(ubq_pdb_gz), codec)
    return np.array(voxelize_frame_atoms(fa, codec), np.float32)


@functools.cache
def _family(name):
    """(Flax module, variables, port module in eval mode) of ``name`` with
    seeded weights. BatchNorm variances are raised by 0.1-0.5 (means kept
    at 0, so that DenseNet's last ReLU passes a signal on 1ubq's sparse
    frames) and DenseNet's head is scaled by 8, away from near-uniform
    rows."""
    import jax

    from timed_design_tpu.models import densenet, prodconn, timed
    from timed_design_tpu_torch.models import MODEL_REGISTRY, TIMED, DenseNet3D, ProDCoNN

    # Built outside inference mode, whatever the first caller runs under:
    # inference-mode parameters would make a later forward outside it fail
    # on autograd instead of the port's own checks.
    with torch.inference_mode(False):
        if name == "TIMED":
            fm, pm = timed(filters=(8, 16)), TIMED(filters=(8, 16))
        elif name == "ProDCoNN":
            fm, pm = prodconn(), ProDCoNN()
        else:
            fm, pm = densenet(**DENSENET), DenseNet3D(**DENSENET)
        v = fm.init(jax.random.key(0), np.zeros((1, 21, 21, 21, 5), np.float32))
        rng = np.random.default_rng(0)
        params = jax.tree.map(np.asarray, v["params"])
        if name == "DenseNet":
            params["Dense_0"]["kernel"] = params["Dense_0"]["kernel"] * 8
        stats = jax.tree.map(np.asarray, v.get("batch_stats", {}))
        for bn in jax.tree.leaves(stats, is_leaf=lambda n: isinstance(n, dict) and "var" in n):
            bn["var"] = bn["var"] + rng.uniform(0.1, 0.5, bn["var"].shape).astype(np.float32)
        variables = {"params": params, "batch_stats": stats}
        pm.load_state_dict(MODEL_REGISTRY[name].convert(variables))
        return fm, variables, pm.eval()


@pytest.fixture(scope="module")
def port_forward(ubq_frames):
    """(name, mode) -> the port's forward on 1ubq in that mode, run once."""
    from timed_design_tpu_torch.models import quantized_convs

    @functools.cache
    def run(name, mode):
        with torch.inference_mode(), quantized_convs(mode):
            return _family(name)[2](torch.from_numpy(ubq_frames)).numpy()

    return run


def _activation_codes(x32) -> np.ndarray:
    x32 = np.asarray(x32, np.float32)
    s = np.maximum(np.float32(np.abs(x32).max()) / np.float32(127.0),
                   np.finfo(np.float32).tiny).astype(np.float32)
    return np.clip(np.round(x32 / s), -127, 127)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name, mode, ubq_frames, monkeypatch):
    """The port's quantized forward against ``quantize_fn(module.apply,
    mode)`` of the JAX package on 1ubq, float32, one batch of 76 frames in
    both (the activation scale spans the batch). Every quantized
    convolution's input is recorded in both packages, and the activation
    codes that differ are counted (module docstring)."""
    import jax
    import jax.numpy as jnp

    import timed_design_tpu.models.quantize as jq
    import timed_design_tpu_torch.models.quantize as tq

    fm, v, pm = _family(name)
    jax_inputs, port_inputs = [], []
    real_gate, real_activation = jq._quantized_conv, tq.quantize_activation

    def gate(mode_, call):
        jax.debug.callback(lambda a: jax_inputs.append(np.asarray(a, np.float32)), call["lhs"],
                           ordered=True)
        return real_gate(mode_, call)

    def activation(x):
        port_inputs.append(x.float().permute(0, 2, 3, 4, 1).numpy().copy())
        return real_activation(x)

    monkeypatch.setattr(jq, "_quantized_conv", gate)
    monkeypatch.setattr(tq, "quantize_activation", activation)
    # XLA's optimizations, which the suite turns off to compile faster, make
    # its emulated int8 convolutions some 20x faster on the CPU
    optimize = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)
    try:
        want = np.asarray(jax.jit(jq.quantize_fn(lambda x: fm.apply(v, x), mode))(
            jnp.asarray(ubq_frames)))
    finally:
        jax.config.update("jax_disable_most_optimizations", optimize)
    with torch.inference_mode(), tq.quantized_convs(mode):
        got = pm(torch.from_numpy(ubq_frames)).numpy()
    assert got.shape == want.shape == (76, 20)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    n_convs = {"TIMED": 3, "ProDCoNN": 4, "DenseNet": 10}[name]
    assert len(jax_inputs) == n_convs
    if mode != "w8":
        assert len(port_inputs) == n_convs
        differ = sum(int((_activation_codes(a) != _activation_codes(b)).sum())
                     for a, b in zip(jax_inputs, port_inputs))
        total = sum(a.size for a in jax_inputs)
        print(f"{name} {mode}: {differ} of {total} activation codes differ from JAX's; "
              f"max |dp| {np.abs(got - want).max():.3g}")
        assert differ <= 1e-5 * total
    else:
        assert not port_inputs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", FAMILIES)
def test_jax_pins_hold_in_port(name, mode, port_forward):
    """``tests/test_quantize.py``'s pins on the port: against the
    unquantized forward, argmax agreement >= 0.95 and |dp| < 2e-3; every
    row sums to 1 within 1e-4."""
    base, q = port_forward(name, None), port_forward(name, mode)
    assert (q.argmax(1) == base.argmax(1)).mean() >= 0.95
    assert np.abs(q - base).max() < 2e-3
    assert np.abs(q - base).max() > 0  # the mode did quantize
    np.testing.assert_allclose(q.sum(axis=1), 1.0, atol=1e-4)


# ------------------------------------------------------ the mode's lifetime

def test_quantized_forward_does_not_leak(ubq_frames):
    """An unquantized forward after a quantized one equals one that never
    saw quantization, bit for bit; the mode is unset after a forward that
    raised; it is per thread."""
    from timed_design_tpu_torch.models.quantize import current_mode, quantize_fn, quantized_convs

    pm = _family("TIMED")[2]
    x = torch.from_numpy(ubq_frames[:8])
    with torch.inference_mode():
        before = pm(x)
        quantize_fn(pm, "int8")(x)
        after = pm(x)
    assert torch.equal(before, after)
    with pytest.raises(ValueError, match="wq must be"):
        with quantized_convs("int8"):
            pm(x[..., :3])  # three channels for a five-channel stem
    assert current_mode() is None
    seen = []
    with quantized_convs("w8"):
        th = threading.Thread(target=lambda: seen.append(current_mode()))
        th.start()
        th.join()
        assert current_mode() == "w8"
    assert seen == [None] and current_mode() is None


def test_quantize_mode_validated():
    from timed_design_tpu_torch.engine import Predictor
    from timed_design_tpu_torch.models import TIMED, quantize_fn, quantized_convs

    with pytest.raises(ValueError, match="quantize mode"):
        quantize_fn(lambda x: x, "int4")
    with pytest.raises(ValueError, match="quantize mode"):
        with quantized_convs("fp8"):
            pass
    with pytest.raises(ValueError, match="quantize mode"):
        Predictor(TIMED(filters=(4,)), batch_size=8, device="cpu", quantize="int4")


def test_predictor_enters_the_mode_on_the_forwards_thread(ubq_frames):
    """A quantized Predictor and a coalescing designer, whose worker thread
    runs the forward, give the quantized module's rows."""
    from timed_design_tpu_torch.engine import DesignSession, Predictor
    from timed_design_tpu_torch.engine.coalescer import CoalescingDesigner
    from timed_design_tpu_torch.models import quantized_convs

    pm = _family("TIMED")[2]
    with torch.inference_mode(), quantized_convs("int8-fake"):
        want = pm(torch.from_numpy(ubq_frames)).numpy()
    p = Predictor(pm, batch_size=76, device="cpu", quantize="int8-fake")
    np.testing.assert_array_equal(p.predict_probs(ubq_frames), want)
    session = DesignSession(pm, codec="CNOCACB", batch_size=76, device="cpu",
                            compute_dtype="float32", quantize="int8-fake")
    d = CoalescingDesigner(session)
    try:
        fa = object()
        probs, got_fa, _ = d.submit_frames(torch.from_numpy(ubq_frames), fa).result()
    finally:
        d.close()
    assert got_fa is fa
    np.testing.assert_array_equal(probs, want)


# ------------------------------------------------------------- on the card

# (Cin, Cout, k, padding, spatial): every convolution shape of the zoo at
# registry widths (TIMED, TIMED deep, ProDCoNN, DenseNet/DenseCPD)
ZOO_SHAPES = [
    (5, 16, 3, 1, 21), (16, 32, 3, 1, 21), (32, 64, 3, 1, 21), (64, 128, 3, 1, 21),
    (128, 20, 1, 0, 21), (128, 338, 1, 0, 21), (128, 256, 3, 1, 21), (256, 256, 3, 1, 21),
    (5, 16, 3, 0, 21), (5, 16, 4, 0, 21), (32, 32, 3, 0, 19), (32, 64, 3, 0, 8),
    (5, 24, 3, 1, 21), (36, 48, 1, 0, 21), (48, 12, 3, 1, 21), (72, 36, 1, 0, 21),
    (42, 48, 1, 0, 10), (84, 42, 1, 0, 10), (78, 48, 1, 0, 5), (48, 12, 3, 1, 5),
    (5, 32, 3, 1, 21), (128, 64, 1, 0, 21), (80, 64, 1, 0, 10), (64, 16, 3, 1, 5),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ZOO_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv3d_int8_kernel_equals_plain(shape, cuda_device):
    """The kernel's int32 sums equal the plain version's on a CPU copy, at
    every convolution shape of the zoo, two frames of random codes; one
    launch each."""
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8, conv3d_int8_plain

    cin, cout, k, pad, s = shape
    x, w = _codes((2, s, s, s, cin), cin), _codes((cout, k, k, k, cin), cout)
    launches = conv3d_int8.launches
    got = conv3d_int8(torch.from_numpy(x).to(cuda_device), torch.from_numpy(w).to(cuda_device),
                      pad)
    torch.cuda.synchronize()
    assert conv3d_int8.launches == launches + 1
    assert torch.equal(got.cpu(), conv3d_int8_plain(torch.from_numpy(x), torch.from_numpy(w), pad))


@functools.lru_cache(maxsize=2)
def _zoo_case(shape):
    """Two frames of random codes at ``shape`` and their plain int32 sums."""
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8_plain

    cin, cout, k, pad, s = shape
    x = torch.from_numpy(_codes((2, s, s, s, cin), cin))
    w = torch.from_numpy(_codes((cout, k, k, k, cin), cout))
    return x, w, conv3d_int8_plain(x, w, pad)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ZOO_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv3d_int8_fused_kernel_equals_plain(shape, dtype, with_bias, cuda_device):
    """The fused kernel (sums, rescale, cast, bias in one launch) equals the
    fused plain version on a CPU copy bit for bit, at every convolution
    shape of the zoo; one launch each."""
    cin, cout, k, pad, s = shape
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8

    dt = getattr(torch, dtype)
    x, w, acc = _zoo_case(shape)
    scale, bias = _epilogue_inputs(cout, dt, cout + k)
    bias = bias if with_bias else None
    launches = conv3d_int8.launches
    got = conv3d_int8(x.to(cuda_device), w.to(cuda_device), pad, scale.to(cuda_device),
                      None if bias is None else bias.to(cuda_device), dt)
    torch.cuda.synchronize()
    assert conv3d_int8.launches == launches + 1
    want = acc.to(torch.float32).mul_(scale).to(dt)
    want = want if bias is None else want + bias
    assert got.dtype == dt and torch.equal(got.cpu(), want)
