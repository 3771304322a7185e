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


@pytest.mark.parametrize("seq", ["R" * 76, "KR" * 38, "RK" * 5 + "H", "D" * 76,
                                 "ACDEFGHIKLMNPQRSTVWY"])
def test_sequence_metrics_at_the_ends_of_the_ph_range(seq):
    """A root of the charge past pH 14 (76 arginines: near 14.2) reads as
    14, the top of the JAX package's bisection bracket; within 1e-4
    relative elsewhere."""
    from timed_design_tpu.sample.metrics import sequence_metrics as jax_seq_metrics

    from timed_design_tpu_torch.sample.metrics import sequence_metrics

    got, want = sequence_metrics(seq), jax_seq_metrics(seq)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[1] <= 14.0


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
@pytest.mark.parametrize("C", [512, 1024, 4096, "limit"])
def test_kernel_past_341_classes_on_card(cuda_device, C):
    """Past C = 341 the kernel's tile has fewer rows (down to one at the
    limit, 25,257 on an H100); codes and counts of both entries stay equal
    to the plain version run on a CPU copy, with a class map and without.
    One class past the limit raises."""
    from timed_design_tpu_torch.ops.sample import (
        max_classes,
        philox_uniforms,
        philox_uniforms_batched,
        sample_codes_plain,
        sample_codes_plain_batched,
        sample_inverse_cdf,
        sample_inverse_cdf_batched,
    )

    if C == "limit":
        C = max_classes(cuda_device)
        with pytest.raises(ValueError, match=f"limit of {C}"):
            sample_inverse_cdf(torch.ones((3, C + 1), device=cuda_device), 4, seed=1)
    L, n, lengths = 37, 50, [16, 0, 13, 8]
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    probs = torch.from_numpy(_probs(L, C, seed=C) ** 4)
    for cmap in (None, torch.from_numpy((np.arange(C) % 23).astype(np.uint8))):
        dmap = None if cmap is None else cmap.to(cuda_device)
        codes, counts = sample_inverse_cdf(probs.to(cuda_device), n, 29, dmap)
        want = sample_codes_plain(probs, torch.from_numpy(philox_uniforms(29, n, L)), cmap)
        torch.testing.assert_close(codes.cpu(), want[0], rtol=0, atol=0)
        torch.testing.assert_close(counts.cpu(), want[1], rtol=0, atol=0)
        head = probs[:offsets[-1]]
        codes, counts = sample_inverse_cdf_batched(head.to(cuda_device), offsets, n, 29, dmap)
        want = sample_codes_plain_batched(
            head, offsets, torch.from_numpy(philox_uniforms_batched(29, n, offsets)), cmap)
        torch.testing.assert_close(codes.cpu(), want[0], rtol=0, atol=0)
        torch.testing.assert_close(counts.cpu(), want[1], rtol=0, atol=0)


def test_cpu_wrapper_takes_any_class_count():
    """On the CPU the wrapper runs the plain version, which has no limit on
    C: 30,000 classes (past the kernel's) draw as the plain version does."""
    from timed_design_tpu_torch.ops.sample import (
        philox_uniforms,
        sample_codes_plain,
        sample_inverse_cdf,
    )

    probs = torch.from_numpy(_probs(5, 30_000, seed=3))
    codes, counts = sample_inverse_cdf(probs, 7, seed=2)
    want = sample_codes_plain(probs, torch.from_numpy(philox_uniforms(2, 7, 5)))
    assert codes.dtype == torch.int16 and int(codes.max()) >= 1000
    assert torch.equal(codes, want[0]) and torch.equal(counts, want[1])


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


def _philox_x0(l, s, b, seed):
    """The first output word of Philox4x32-10 at counter (l, s, b, 0) under
    the seed's key, in Python integers."""
    M = 0xFFFFFFFF
    c, k0, k1 = [l, s, b, 0], seed & M, (seed >> 32) & M
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M, (k1 + 0xBB67AE85) & M
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M, (p0 >> 32) ^ c[3] ^ k1, p0 & M]
    return c[0]


def test_philox_uniforms_with_a_structure_word():
    """Known answers with a nonzero structure word, written out in Python
    integers; the batched uniforms hold each structure's own, and structure
    0 draws what the single entry draws."""
    from timed_design_tpu_torch.ops.sample import philox_uniforms, philox_uniforms_batched

    seed = 0x0123456789ABCDEF
    for b in (1, 7, 0xFFFFFFFF):
        u = philox_uniforms(seed, 3, 5, structure=b)
        want = [[(_philox_x0(l, s, b, seed) >> 8) * 2.0**-24 for l in range(5)] for s in range(3)]
        assert u.dtype == np.float32
        np.testing.assert_array_equal(u, np.array(want, np.float32))
    assert _philox_x0(0, 0, 1, seed) != _philox_x0(0, 0, 0, seed)
    offsets = [0, 4, 4, 13, 14]
    got = philox_uniforms_batched(seed, 6, offsets)
    assert got.shape == (6, 14)
    for b, (a, e) in enumerate(zip(offsets, offsets[1:])):
        np.testing.assert_array_equal(got[:, a:e], philox_uniforms(seed, 6, e - a, b))
    np.testing.assert_array_equal(philox_uniforms(seed, 6, 9), philox_uniforms(seed, 6, 9, 0))


@pytest.mark.parametrize("C,rotamer", [(20, False), (338, True), (338, False)])
def test_batched_wrapper_on_cpu(C, rotamer):
    """B = 1 gives the single entry's codes and counts; structure b of a
    batch is ``sample_codes_plain`` on its rows and its own uniforms; empty
    structures and malformed offsets."""
    from timed_design_tpu_torch.ops.sample import (
        philox_uniforms,
        sample_codes_plain,
        sample_inverse_cdf,
        sample_inverse_cdf_batched,
    )

    probs = torch.from_numpy(_probs(61, C, seed=C) ** 3)
    cmap = _rotamer_map() if rotamer else None
    launches = sample_inverse_cdf_batched.launches
    one = sample_inverse_cdf_batched(probs, [0, 61], 40, 9, cmap)
    codes, counts = sample_inverse_cdf(probs, 40, 9, cmap)
    assert torch.equal(one[0], codes) and torch.equal(one[1][0], counts)
    assert one[1].shape == (1, 40, 20)
    offsets = [0, 5, 5, 38, 61]
    codes, counts = sample_inverse_cdf_batched(probs, torch.tensor(offsets), 40, 9, cmap)
    assert codes.shape == (40, 61) and counts.shape == (4, 40, 20)
    for b, (a, e) in enumerate(zip(offsets, offsets[1:])):
        u = torch.from_numpy(philox_uniforms(9, 40, e - a, b))
        want_codes, want_counts = sample_codes_plain(probs[a:e], u, cmap)
        assert torch.equal(codes[:, a:e], want_codes) and torch.equal(counts[b], want_counts)
    assert sample_inverse_cdf_batched.launches == launches  # no kernel on the CPU
    assert counts[1].sum() == 0
    for bad in ([0, 5, 60], [1, 61], [0, 30, 20, 61], [[0, 61]], [0.0, 61.0]):
        with pytest.raises(ValueError, match="offsets"):
            sample_inverse_cdf_batched(probs, bad, 4, 0, cmap)


def _jax_bucket_uniforms(seed, n, lengths, pad_to=32):
    """(n, sum L) uniforms that JAX's ``sample_all_structures`` draws: one
    key per structure from ``split``, ``uniform(key, (n, Lp, 1))`` at the
    padded length, trimmed to the structure's."""
    import jax

    keys = jax.random.split(jax.random.key(seed), len(lengths))
    return np.concatenate([
        np.asarray(jax.random.uniform(keys[i], (n, -(-L // pad_to) * pad_to, 1)))[:, :L, 0]
        for i, L in enumerate(lengths)], axis=1)


@pytest.mark.parametrize("C,rotamer", [(20, False), (338, True)])
def test_batched_plain_on_jax_uniforms_matches_jax_sample_all_structures(C, rotamer):
    """Fed JAX's own uniforms, ``sample_codes_plain_batched`` gives the
    sequences of JAX's ``sample_all_structures`` (two length buckets),
    identical, and metrics from its counts within 1e-4."""
    from timed_design_tpu.sample.sampler import sample_all_structures as jax_sample_all

    from timed_design_tpu_torch.constants import AA1
    from timed_design_tpu_torch.ops.sample import sample_codes_plain_batched
    from timed_design_tpu_torch.sample import batched_metrics_from_counts

    lengths, n, seed = [5, 40, 33, 1], 16, 12
    arrays = [_probs(L, C, seed=i) ** 2 for i, L in enumerate(lengths)]
    arrays = [a / a.sum(1, keepdims=True) for a in arrays]
    pdbs = [f"s{i}" for i in range(len(lengths))]
    want = jax_sample_all(dict(zip(pdbs, arrays)), n, seed=seed, rotamer_mode=rotamer)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    u = torch.from_numpy(_jax_bucket_uniforms(seed, n, lengths))
    codes, counts = sample_codes_plain_batched(torch.from_numpy(np.concatenate(arrays)), offsets,
                                               u, _rotamer_map() if rotamer else None)
    metrics = batched_metrics_from_counts(counts.reshape(-1, 20).float())
    keys = ("charge", "isoelectric_point", "molecular_weight", "molar_extinction_280")
    m = torch.stack([metrics[k] for k in keys], 1).reshape(len(lengths), n, 4).numpy()
    letters = np.array(list(AA1))
    for b, pdb in enumerate(pdbs):
        seqs = ["".join(letters[row]) for row in codes[:, offsets[b]:offsets[b + 1]].long().numpy()]
        assert seqs == [s for s, *_ in want[pdb]]
        np.testing.assert_allclose(m[b], np.array([r[1:] for r in want[pdb]]), rtol=1e-4, atol=1e-4)


def test_sample_all_structures_statistics_and_determinism():
    """On the CPU: 4000 samples per structure follow each structure's
    distribution to 0.01; a sequence depends on (seed, structure index,
    sample) only; metrics are each sequence's."""
    from timed_design_tpu_torch.sample import sample_all_structures, sequence_metrics

    a = np.tile(np.array([0.5, 0.3, 0.2] + [0.0] * 17, np.float32), (10, 1))
    b = np.tile(np.array([0.0] * 10 + [0.1, 0.9] + [0.0] * 8, np.float32), (7, 1))
    out = sample_all_structures({"a": a, "b": b}, 4000, seed=3, device="cpu")
    assert list(out) == ["a", "b"]
    for key, probs in (("a", a), ("b", b)):
        seqs = [s for s, *_ in out[key]]
        assert len(seqs) == 4000 and {len(s) for s in seqs} == {probs.shape[0]}
        letters = np.frombuffer("".join(seqs).encode(), np.uint8)
        freq = np.array([(letters == ord(c)).mean() for c in "ACDEFGHIKLMNPQRSTVWY"])
        np.testing.assert_allclose(freq, probs[0], atol=0.01)
    for s, *m in out["a"][:5] + out["b"][:5]:
        np.testing.assert_allclose(m, sequence_metrics(s), rtol=1e-5)
    again = sample_all_structures({"a": a, "c": b[:3]}, 50, seed=3, device="cpu")
    assert again["a"] == out["a"][:50]
    assert [s for s, *_ in again["c"]] == [s[:3] for s, *_ in out["b"][:50]]
    assert sample_all_structures({}, 5, device="cpu") == {}
    with pytest.raises(ValueError, match="class count"):
        sample_all_structures({"a": a, "r": np.ones((3, 338), np.float32)}, 5, device="cpu")


@pytest.mark.parametrize("temperature", [0.0, 0.3, 1.0, 2.5])
def test_apply_temperature_on_float64_numpy_is_numpy_bit_for_bit(temperature):
    """td-sample scales the float64 matrix on the host: the port's numpy
    path equals the JAX package's (numpy) bit for bit, in float64."""
    from timed_design_tpu.sample.sampler import apply_temperature as jax_temp

    from timed_design_tpu_torch.sample import apply_temperature

    p = np.random.default_rng(7).random((50, 338)) ** 3
    got, want = apply_temperature(p, temperature), jax_temp(p, temperature)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64 == want.dtype
    np.testing.assert_array_equal(got, want)


def _sample_inputs(d, C, rng_seed=0):
    """A float16 prediction CSV and an old-format datasetmap, written with
    the port's writers: three structures of 9, 14 and 4 residues."""
    from timed_design_tpu_torch.io import DatasetMap, save_datasetmap, save_prediction_csv

    d.mkdir()
    chains = [("1abc", "A", 9), ("1abc", "B", 14), ("2xyz", "A", 4)]
    p = np.random.default_rng(rng_seed).random((27, C)).astype(np.float32) ** 4
    csv = save_prediction_csv(p / p.sum(1, keepdims=True), "TIMED", d, rotamer=C == 338)
    entries = [(pdb, ch, str(i + 1), "ALA") for pdb, ch, n in chains for i in range(n)]
    dmap = save_datasetmap(DatasetMap(entries=entries), d / "datasetmap.txt")
    return csv, dmap


@pytest.mark.parametrize("C", [20, 338])
def test_main_sample_against_jax(tmp_path, monkeypatch, C):
    """Same file names, headers and record counts as the JAX package's
    ``main_sample``; 338 classes switch rotamer decoding on by themselves;
    at T = 0 every sample is the argmax sequence, so the temperature was
    applied to the matrix; the metrics are each sequence's."""
    import json

    from timed_design_tpu.sample import SampleConfig as JaxConfig
    from timed_design_tpu.sample import main_sample as jax_main

    from timed_design_tpu_torch.io import extract_sequences, load_datasetmap, load_prediction_matrix
    from timed_design_tpu_torch.constants import ROTAMER_CATEGORIES
    from timed_design_tpu_torch.sample import SampleConfig, main_sample, sequence_metrics

    csv, dmap = _sample_inputs(tmp_path / "in", C)
    kw = dict(path_to_pred_matrix=csv, path_to_datasetmap=dmap, sample_n=6,
              support_old_datasetmap=True, temperature=0.5)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = jax_main(JaxConfig(**kw))
    monkeypatch.chdir(tmp_path / "port")
    got = main_sample(SampleConfig(**kw, device="cpu"))
    assert got == want == [f"{csv.stem}_temp_0.5_n_6_1abcA{ext}"
                           for ext in (".json", ".fasta", "_metrics.csv")]
    for name in got:
        mine = (tmp_path / "port" / name).read_text().splitlines()
        theirs = (tmp_path / "jax" / name).read_text().splitlines()
        assert len(mine) == len(theirs) and mine[0][:1] == theirs[0][:1]
        if name.endswith(".csv"):
            assert mine[0] == theirs[0] and len(mine) == 1 + 3 * 6
    js = json.loads((tmp_path / "port" / got[0]).read_text())
    assert list(js) == ["1abcA", "1abcB", "2xyzA"] and all(len(v) == 6 for v in js.values())
    assert [len(v[0][0]) for v in js.values()] == [9, 14, 4]
    for seq, *m in js["1abcB"]:
        np.testing.assert_allclose(m, sequence_metrics(seq), rtol=1e-5)

    got = main_sample(SampleConfig(**{**kw, "temperature": 0.0}, device="cpu"))
    decoded = extract_sequences(load_datasetmap(dmap, is_old=True), load_prediction_matrix(csv),
                                ROTAMER_CATEGORIES if C == 338 else None)
    js = json.loads((tmp_path / "port" / got[0]).read_text())
    assert {k: {s for s, *_ in v} for k, v in js.items()} == {
        k: {s} for k, s in decoded.pdb_to_sequence.items()}


def test_main_sample_refusals(tmp_path):
    """A 20-class matrix with --predict_rotamers and a matrix of another
    class count raise as in the JAX package; missing files raise."""
    from timed_design_tpu.sample import SampleConfig as JaxConfig
    from timed_design_tpu.sample import main_sample as jax_main

    from timed_design_tpu_torch.sample import SampleConfig, main_sample

    csv, dmap = _sample_inputs(tmp_path / "in20", 20)
    kw = dict(path_to_pred_matrix=csv, path_to_datasetmap=dmap, predict_rotamers=True,
              support_old_datasetmap=True)
    for run, cfg in ((jax_main, JaxConfig(**kw)), (main_sample, SampleConfig(**kw, device="cpu"))):
        with pytest.raises(ValueError, match="20 classes but --predict_rotamers"):
            run(cfg)
    csv, dmap = _sample_inputs(tmp_path / "in7", 7)
    with pytest.raises(ValueError, match="7 classes; expected 20 or 338"):
        main_sample(SampleConfig(csv, dmap, support_old_datasetmap=True, device="cpu"))
    with pytest.raises(FileNotFoundError, match="Prediction matrix"):
        main_sample(SampleConfig(tmp_path / "nope.csv", dmap, device="cpu"))


def test_main_sample_statistics_on_cpu(tmp_path, monkeypatch):
    """Through ``main_sample`` on the CPU: 4000 samples of each structure
    follow its CSV rows (exact in float16, the same at every position) to
    0.01, over all its positions."""
    import json

    from timed_design_tpu_torch.io import DatasetMap, save_datasetmap, save_prediction_csv
    from timed_design_tpu_torch.sample import SampleConfig, main_sample

    p = np.zeros((6, 20))
    p[:4, [0, 1, 2]] = [0.5, 0.25, 0.25]  # 1abcA: A, C, D
    p[4:, [8, 18]] = [0.75, 0.25]  # 2xyzA: K, W
    csv = save_prediction_csv(p, "TIMED", tmp_path)
    entries = [("1abc", "A", str(i), "ALA") for i in range(4)] + [
        ("2xyz", "A", str(i), "ALA") for i in range(2)]
    dmap = save_datasetmap(DatasetMap(entries=entries), tmp_path / "datasetmap.txt")
    monkeypatch.chdir(tmp_path)
    paths = main_sample(SampleConfig(csv, dmap, sample_n=4000, save_as="json",
                                     support_old_datasetmap=True, device="cpu"))
    js = json.loads((tmp_path / paths[0]).read_text())
    for pdb, rows in (("1abcA", p[:4]), ("2xyzA", p[4:])):
        seqs = np.array([list(s) for s, *_ in js[pdb]])
        assert seqs.shape == (4000, rows.shape[0])
        freq = np.array([(seqs == c).mean() for c in "ACDEFGHIKLMNPQRSTVWY"])
        np.testing.assert_allclose(freq, rows[0], atol=0.01)


def test_sample_cli_on_cpu_and_without_a_card(tmp_path):
    """``python -m timed_design_tpu_torch.cli.sample --device cpu`` writes
    the three files; the default device is the card, and without one the
    command exits non-zero with a message."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from timed_design_tpu_torch.cli.sample import build_parser

    repo = Path(__file__).resolve().parent.parent
    csv, dmap = _sample_inputs(tmp_path / "in", 338)
    args = ["--path_to_pred_matrix", str(csv), "--path_to_datasetmap", str(dmap),
            "--support_old_datasetmap", "--sample_n", "3", "--workers", "4"]
    assert build_parser().parse_args(args).device == "cuda"
    env = dict(os.environ, PYTHONPATH=str(repo), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    run = [sys.executable, "-m", "timed_design_tpu_torch.cli.sample", *args]
    proc = subprocess.run(run + ["--device", "cpu"], capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "338-class matrix detected" in proc.stdout
    assert sorted(p.name for p in tmp_path.glob("TIMED_rot_temp_*")) == [
        f"TIMED_rot_temp_1.0_n_3_1abcA{e}" for e in (".fasta", ".json", "_metrics.csv")]
    if not torch.cuda.is_available():
        proc = subprocess.run(run, capture_output=True, text=True, env=env, cwd=tmp_path,
                              timeout=300)
        assert proc.returncode != 0 and "--device cpu" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("lengths,C,n,rotamer", [
    ([76, 129, 1, 760, 33], 338, 100, True), ([25, 40, 33], 20, 256, False),
    ([16, 0, 48, 5], 338, 70, False), ([76] * 11, 338, 100, True),
    ([16, 0, 48, 4, 40], 338, 70, False)])
def test_batched_kernel_matches_plain_on_card(cuda_device, lengths, C, n, rotamer):
    """Codes and counts of one batched launch equal to the plain version run
    on a CPU copy; B = 1 equals the single entry bit for bit. The last two
    batches have every start and length a multiple of 4, where the kernel
    stores four codes at once (uint8 codes with the map, int16 without)."""
    from timed_design_tpu_torch.ops.sample import (
        philox_uniforms_batched,
        sample_codes_plain_batched,
        sample_inverse_cdf,
        sample_inverse_cdf_batched,
    )

    offsets = np.concatenate([[0], np.cumsum(lengths)])
    probs = torch.from_numpy(_probs(int(offsets[-1]), C) ** 4)
    cmap = _rotamer_map() if rotamer else None
    dmap = None if cmap is None else cmap.to(cuda_device)
    launches = sample_inverse_cdf_batched.launches
    codes, counts = sample_inverse_cdf_batched(probs.to(cuda_device), offsets, n, 23, dmap)
    torch.cuda.synchronize()
    assert sample_inverse_cdf_batched.launches == launches + 1
    want = sample_codes_plain_batched(probs, offsets,
                                      torch.from_numpy(philox_uniforms_batched(23, n, offsets)), cmap)
    torch.testing.assert_close(codes.cpu(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(counts.cpu(), want[1], rtol=0, atol=0)
    one = probs[:lengths[0]].to(cuda_device)
    a = sample_inverse_cdf_batched(one, torch.tensor([0, lengths[0]], dtype=torch.int32,
                                                     device=cuda_device), n, 23, dmap)
    b = sample_inverse_cdf(one, n, 23, dmap)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1])
