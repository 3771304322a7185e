"""PyTorch port, sampling: the kernel's plain version, temperature and
metrics against the JAX package; the CUDA kernel against its plain version
on the card.

The Pallas kernel has no interpret-mode PRNG, so the XLA samplers
``sample_class_indices`` and ``sample_sequences_with_metrics`` are the JAX
reference: fed JAX's own uniforms, the port's plain version must give
identical indices, codes and counts (exact: integers, and the same float32
CDF). Metrics agree to 1e-4 relative (float32 sums in another order).
"""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _probs(L, C, seed=0):
    p = np.random.default_rng(seed).random((L, C)).astype(np.float32)
    return p / p.sum(1, keepdims=True)


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 distribution."""
    from timed_design_tpu_torch.ops.sample import philox4x32_10

    M = 0xFFFFFFFF
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((M, M, M, M), (M, M), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        assert tuple(int(w) for w in philox4x32_10(ctr, key)) == want


@pytest.mark.parametrize("L,C,n", [(9, 20, 64), (76, 338, 32)])
def test_plain_sampler_matches_jax_on_jax_uniforms(L, C, n):
    import jax
    import jax.numpy as jnp

    from timed_design_tpu.sample.sampler import sample_class_indices as jax_sample

    from timed_design_tpu_torch.ops.sample import sample_class_indices_plain

    p = jnp.asarray(_probs(L, C))
    key = jax.random.key(3)
    want = np.asarray(jax_sample(key, p, n))
    u = np.asarray(jax.random.uniform(key, (n, L, 1)))[..., 0]
    cdf = np.asarray(jnp.cumsum(p, axis=-1))
    got = sample_class_indices_plain(torch.from_numpy(cdf), torch.from_numpy(u)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_plain_sampler_under_mass_rows_give_class_zero():
    """u past the row's mass gives class 0, as JAX's argmax form does."""
    import jax
    import jax.numpy as jnp

    from timed_design_tpu.sample.sampler import sample_class_indices as jax_sample

    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf

    p = np.zeros((1, 20), np.float32)
    p[0, 3] = p[0, 7] = 0.25  # total mass 0.5
    codes, counts = sample_inverse_cdf(torch.from_numpy(p), 100_000, seed=11)
    got = codes.numpy().ravel()
    freq = np.bincount(got, minlength=20) / got.size
    np.testing.assert_allclose(freq[[0, 3, 7]], [0.5, 0.25, 0.25], atol=0.01)
    assert freq.sum() == pytest.approx(1.0) and freq[[0, 3, 7]].sum() == pytest.approx(1.0)
    np.testing.assert_array_equal(counts.numpy(), np.eye(20, dtype=np.int32)[got])
    ref = np.asarray(jax_sample(jax.random.key(0), jnp.asarray(p), 100_000)).ravel()
    np.testing.assert_allclose(freq, np.bincount(ref, minlength=20) / ref.size, atol=0.01)


def test_cpu_wrapper_statistics_and_determinism():
    """On a CPU tensor the wrapper is the plain version on Philox uniforms:
    1e6 draws match the distribution, the seed fixes the draws."""
    from timed_design_tpu_torch.ops.sample import (
        philox_uniforms,
        sample_class_indices_plain,
        sample_inverse_cdf,
    )

    probs = torch.tensor([[0.5, 0.3, 0.2] + [0.0] * 17])
    launches = sample_inverse_cdf.launches
    codes, counts = sample_inverse_cdf(probs, 1_000_000, seed=1)
    idx = codes.numpy().ravel()
    assert codes.dtype == torch.uint8 and counts.dtype == torch.int32
    freq = np.bincount(idx, minlength=20) / idx.size
    np.testing.assert_allclose(freq[:3], [0.5, 0.3, 0.2], atol=0.01)
    assert freq[3:].sum() == 0
    assert sample_inverse_cdf.launches == launches  # no kernel on the CPU

    probs = torch.from_numpy(_probs(76, 338))
    a, _ = sample_inverse_cdf(probs, 50, seed=5)
    assert a.dtype == torch.int16  # 338 unmapped classes do not fit a byte
    u = torch.from_numpy(philox_uniforms(5, 50, 76))
    want = sample_class_indices_plain(torch.cumsum(probs, -1), u)
    torch.testing.assert_close(a.int(), want, rtol=0, atol=0)
    torch.testing.assert_close(a, sample_inverse_cdf(probs, 50, seed=5)[0])
    assert (a != sample_inverse_cdf(probs, 50, seed=6)[0]).any()
    codes, counts = sample_inverse_cdf(probs, 0, seed=5)
    assert codes.shape == (0, 76) and counts.shape == (0, 20)
    with pytest.raises(ValueError):
        sample_inverse_cdf(probs.double(), 4, seed=0)
    with pytest.raises(ValueError, match="class_map"):
        sample_inverse_cdf(probs, 4, seed=0, class_map=torch.zeros(338, dtype=torch.int32))


def _rotamer_map():
    from timed_design_tpu_torch.constants import ROTAMER_TO_AA

    return torch.from_numpy(ROTAMER_TO_AA.astype(np.uint8))


@pytest.mark.parametrize("L,C,n,rotamer", [
    (9, 20, 64, False), (76, 338, 32, False), (76, 338, 32, True),
    (200, 338, 7, False), (200, 338, 7, True)])
def test_sample_codes_plain_equals_old_composition(L, C, n, rotamer):
    """One call = cumsum, count of CDF entries <= u, the rotamer gather and
    the one-hot counts, as the serving path composed them before."""
    from timed_design_tpu_torch.ops.sample import (
        philox_uniforms,
        sample_class_indices_plain,
        sample_codes_plain,
    )
    from timed_design_tpu_torch.sample import counts_from_codes

    probs = torch.from_numpy(_probs(L, C, seed=L) ** 3)
    u = torch.from_numpy(philox_uniforms(21, n, L))
    cmap = _rotamer_map() if rotamer else None
    codes, counts = sample_codes_plain(probs, u, cmap)
    idx = sample_class_indices_plain(torch.cumsum(probs, dim=-1), u)
    want = cmap.long()[idx.long()] if rotamer else idx.long()
    np.testing.assert_array_equal(codes.long().numpy(), want.numpy())
    assert codes.dtype == (torch.uint8 if rotamer or C <= 256 else torch.int16)
    in_range = torch.where(want < 20, want, 0)
    old = counts_from_codes(in_range, (want < 20).float())
    np.testing.assert_array_equal(counts.numpy(), old.numpy().astype(np.int32))


@pytest.mark.parametrize("L,C,n,rotamer", [
    (9, 20, 64, False), (76, 338, 32, False), (76, 338, 32, True)])
def test_sample_codes_plain_matches_jax_sample_sequences_with_metrics(L, C, n, rotamer):
    """Fed JAX's own uniforms, the plain version gives the codes and counts
    of ``sample_sequences_with_metrics``; metrics from the counts agree to
    1e-4 relative."""
    import jax

    from timed_design_tpu.sample.metrics import counts_from_codes as jax_counts
    from timed_design_tpu.sample.sampler import sample_sequences_with_metrics as jax_ssm

    from timed_design_tpu_torch.ops.sample import sample_codes_plain
    from timed_design_tpu_torch.sample import batched_metrics_from_counts

    p = _probs(L, C, seed=5)
    key = jax.random.key(8)
    want_codes, want_metrics = jax_ssm(key, p, n, rotamer_mode=rotamer)
    want_codes = np.asarray(want_codes)
    u = np.asarray(jax.random.uniform(key, (n, L, 1)))[..., 0]
    codes, counts = sample_codes_plain(torch.from_numpy(p), torch.from_numpy(u),
                                       _rotamer_map() if rotamer else None)
    np.testing.assert_array_equal(codes.long().numpy(), want_codes)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jax_counts(want_codes)))
    got = batched_metrics_from_counts(counts.float())
    for k in ("charge", "isoelectric_point", "molecular_weight", "molar_extinction_280"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want_metrics[k]),
                                   rtol=1e-4, atol=1e-4)


def test_sample_codes_plain_cdf_is_the_cpu_cumsum():
    """The plain version's float64-accumulated CDF is bit for bit the CPU's
    float32 cumsum, which the kernel reproduces."""
    p = torch.from_numpy(_probs(76, 338, seed=3) ** 5)
    want = torch.cumsum(p, dim=-1)
    got = torch.cumsum(p.to(torch.float64), dim=-1).to(torch.float32)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        want.numpy(), np.cumsum(p.numpy().astype(np.float64), axis=-1).astype(np.float32))


def _draw_threshold(x: int) -> int:
    """The kernel's draw_threshold (csrc/sample_inverse_cdf.cu), written out:
    the bits of the largest double that rounds to a float32 <= u."""
    k = x >> 8
    if k == 0:
        return (1023 - 150) << 52
    e = k.bit_length() - 1
    u_bits = ((1023 + e - 24) << 52) | ((k << (52 - e)) & ((1 << 52) - 1))
    m_bits = u_bits + (1 << 28)
    return m_bits - 1 if e == 23 and k & 1 else m_bits


def test_draw_threshold_rule():
    """(float)cdf <= u exactly when the bits of the double cdf are <= the
    threshold: the threshold rounds to u or below, the next double above it
    rounds above u, and its u is the kernel's uniform."""
    words = np.random.default_rng(6).integers(0, 2**32, 20_000).tolist()
    words += [0, 255, 256, 511, 2**31, 2**32 - 1, 2**32 - 256, 2**31 + 256]
    for x in words:
        u = np.float32(x >> 8) * np.float32(2.0**-24)
        t = np.array([_draw_threshold(x)], np.int64).view(np.float64)[0]
        assert np.float32(t) <= u < np.float32(np.nextafter(t, np.inf))


@pytest.mark.parametrize("temperature", [0.0, 0.2, 1.0, 2.0])
def test_apply_temperature_matches_jax(temperature):
    from timed_design_tpu.sample.sampler import apply_temperature as jax_temp

    from timed_design_tpu_torch.sample import apply_temperature

    p = _probs(30, 20, seed=2)
    p[4] = 0.0
    p[4, 7] = 1.0  # a one-hot row
    got = apply_temperature(torch.from_numpy(p), temperature).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_temp(p, temperature)), rtol=1e-5, atol=1e-7)


def test_metrics_match_jax():
    """Counts exact; charge, pI, MW and ext280 within 1e-4 relative."""
    from timed_design_tpu.sample.metrics import batched_metrics_from_counts as jax_metrics
    from timed_design_tpu.sample.metrics import counts_from_codes as jax_counts

    from timed_design_tpu_torch.sample import batched_metrics_from_counts, counts_from_codes

    rng = np.random.default_rng(4)
    codes = rng.integers(0, 20, (64, 90)).astype(np.int32)
    mask = (np.arange(90) < 70).astype(np.float32)
    got_c = counts_from_codes(torch.from_numpy(codes), torch.from_numpy(mask)[None])
    want_c = np.asarray(jax_counts(codes, mask[None]))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    got = batched_metrics_from_counts(got_c)
    want = jax_metrics(want_c)
    for k in ("charge", "isoelectric_point", "molecular_weight", "molar_extinction_280"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4)


def test_sample_structure_rotamer_mode():
    """Rotamer draws collapse to amino acids; metrics match each sequence."""
    from timed_design_tpu.constants import ROTAMER_TO_AA
    from timed_design_tpu.sample.metrics import sequence_metrics as jax_seq_metrics

    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf
    from timed_design_tpu_torch.sample import apply_temperature, sample_structure

    p = _probs(40, 338, seed=8)
    out = sample_structure(p, 6, seed=9, rotamer_mode=True, temperature=0.5, device="cpu")
    assert out == sample_structure(p, 6, seed=9, rotamer_mode=True, temperature=0.5,
                                   device="cpu")
    idx, _ = sample_inverse_cdf(apply_temperature(torch.from_numpy(p), 0.5), 6, 9)
    seqs = ["".join("ACDEFGHIKLMNPQRSTVWY"[a] for a in ROTAMER_TO_AA[row])
            for row in idx.numpy()]
    assert [s for s, *_ in out] == seqs
    for s, *m in out:
        np.testing.assert_allclose(m, jax_seq_metrics(s), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("L,C,n,rotamer", [
    (76, 338, 1000, False), (76, 338, 1000, True), (1024, 20, 256, False),
    (4096, 338, 64, False), (4096, 338, 64, True), (75, 338, 33, True), (75, 20, 33, False)])
def test_kernel_matches_plain_on_card(cuda_device, L, C, n, rotamer):
    """Codes and counts equal to the plain version run on a CPU copy."""
    from timed_design_tpu_torch.ops.sample import (
        philox_uniforms,
        sample_codes_plain,
        sample_inverse_cdf,
    )

    probs = torch.from_numpy(_probs(L, C) ** 4)
    cmap = _rotamer_map() if rotamer else None
    launches = sample_inverse_cdf.launches
    codes, counts = sample_inverse_cdf(probs.to(cuda_device), n, seed=17,
                                       class_map=None if cmap is None else cmap.to(cuda_device))
    torch.cuda.synchronize()
    assert sample_inverse_cdf.launches == launches + 1
    want_codes, want_counts = sample_codes_plain(
        probs, torch.from_numpy(philox_uniforms(17, n, L)), cmap)
    assert codes.dtype == want_codes.dtype
    torch.testing.assert_close(codes.cpu(), want_codes, rtol=0, atol=0)
    torch.testing.assert_close(counts.cpu(), want_counts, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_statistics_on_card(cuda_device):
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf

    probs = torch.tensor([[0.5, 0.3, 0.2] + [0.0] * 17], device=cuda_device)
    idx = sample_inverse_cdf(probs, 1_000_000, seed=1)[0].cpu().numpy().ravel()
    np.testing.assert_allclose(np.bincount(idx, minlength=20)[:3] / idx.size,
                               [0.5, 0.3, 0.2], atol=0.01)
    half = torch.zeros((1, 20), device=cuda_device)
    half[0, 3] = half[0, 7] = 0.25
    idx = sample_inverse_cdf(half, 100_000, seed=11)[0].cpu().numpy().ravel()
    np.testing.assert_allclose((idx == 0).mean(), 0.5, atol=0.01)
    assert set(np.unique(idx)) <= {0, 3, 7}
