"""PyTorch port, sampling: the kernel's plain version, temperature and
metrics against the JAX package; the CUDA kernel against its plain version
on the card.

The Pallas kernel has no interpret-mode PRNG, so the XLA sampler
``sample_class_indices`` is the JAX reference: fed JAX's own uniforms and
CDF, the port's plain version must give identical indices.
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

    from timed_design_tpu_torch.ops.sample import sample_class_indices

    p = np.zeros((1, 20), np.float32)
    p[0, 3] = p[0, 7] = 0.25  # total mass 0.5
    got = sample_class_indices(torch.from_numpy(p), 100_000, seed=11).numpy().ravel()
    freq = np.bincount(got, minlength=20) / got.size
    np.testing.assert_allclose(freq[[0, 3, 7]], [0.5, 0.25, 0.25], atol=0.01)
    assert freq.sum() == pytest.approx(1.0) and freq[[0, 3, 7]].sum() == pytest.approx(1.0)
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

    cdf = torch.cumsum(torch.tensor([[0.5, 0.3, 0.2] + [0.0] * 17]), -1)
    launches = sample_inverse_cdf.launches
    idx = sample_inverse_cdf(cdf, 1_000_000, seed=1).numpy().ravel()
    freq = np.bincount(idx, minlength=20) / idx.size
    np.testing.assert_allclose(freq[:3], [0.5, 0.3, 0.2], atol=0.01)
    assert freq[3:].sum() == 0
    assert sample_inverse_cdf.launches == launches  # no kernel on the CPU

    cdf = torch.cumsum(torch.from_numpy(_probs(76, 338)), -1)
    a = sample_inverse_cdf(cdf, 50, seed=5)
    u = torch.from_numpy(philox_uniforms(5, 50, 76))
    torch.testing.assert_close(a, sample_class_indices_plain(cdf, u))
    torch.testing.assert_close(a, sample_inverse_cdf(cdf, 50, seed=5))
    assert (a != sample_inverse_cdf(cdf, 50, seed=6)).any()
    assert sample_inverse_cdf(cdf, 0, seed=5).shape == (0, 76)
    with pytest.raises(ValueError):
        sample_inverse_cdf(cdf.double(), 4, seed=0)


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

    from timed_design_tpu_torch.ops.sample import sample_class_indices
    from timed_design_tpu_torch.sample import sample_structure

    p = _probs(40, 338, seed=8)
    out = sample_structure(p, 6, seed=9, rotamer_mode=True, temperature=0.5)
    assert out == sample_structure(p, 6, seed=9, rotamer_mode=True, temperature=0.5)
    from timed_design_tpu_torch.sample import apply_temperature

    idx = sample_class_indices(apply_temperature(torch.from_numpy(p), 0.5), 6, 9).numpy()
    seqs = ["".join("ACDEFGHIKLMNPQRSTVWY"[a] for a in ROTAMER_TO_AA[row]) for row in idx]
    assert [s for s, *_ in out] == seqs
    for s, *m in out:
        np.testing.assert_allclose(m, jax_seq_metrics(s), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("L,C,n", [(76, 338, 1000), (1024, 20, 256), (4096, 338, 64)])
def test_kernel_matches_plain_on_card(cuda_device, L, C, n):
    from timed_design_tpu_torch.ops.sample import (
        philox_uniforms,
        sample_class_indices_plain,
        sample_inverse_cdf,
    )

    cdf = torch.cumsum(torch.from_numpy(_probs(L, C)).to(cuda_device), -1)
    launches = sample_inverse_cdf.launches
    got = sample_inverse_cdf(cdf, n, seed=17)
    torch.cuda.synchronize()
    assert sample_inverse_cdf.launches == launches + 1
    u = torch.from_numpy(philox_uniforms(17, n, L)).to(cuda_device)
    torch.testing.assert_close(got, sample_class_indices_plain(cdf, u), rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_statistics_on_card(cuda_device):
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf

    cdf = torch.cumsum(torch.tensor([[0.5, 0.3, 0.2] + [0.0] * 17], device=cuda_device), -1)
    idx = sample_inverse_cdf(cdf, 1_000_000, seed=1).cpu().numpy().ravel()
    np.testing.assert_allclose(np.bincount(idx, minlength=20)[:3] / idx.size,
                               [0.5, 0.3, 0.2], atol=0.01)
    half = torch.zeros((1, 20), device=cuda_device)
    half[0, 3] = half[0, 7] = 0.25
    idx = sample_inverse_cdf(torch.cumsum(half, -1), 100_000, seed=11).cpu().numpy().ravel()
    np.testing.assert_allclose((idx == 0).mean(), 0.5, atol=0.01)
    assert set(np.unique(idx)) <= {0, 3, 7}
