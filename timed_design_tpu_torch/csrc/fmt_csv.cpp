// Vectorized "%.18e" CSV row formatter for the prediction-matrix writers.
//
// np.savetxt formats one Python float per cell (~1.5 us/value measured);
// at the reference's benchmark scale (500k-1M frames x 338 rotamer
// classes, scripts/run_benchmark_models.sh) that makes the full-precision
// CSV stream the dominant host cost of the whole engine. snprintf("%.18e")
// produces the SAME bytes — glibc printf and CPython's dtoa are both
// correctly rounded, and every finite non-negative double that fits a
// two-digit exponent formats to exactly 24 characters — at ~5x the speed
// single-threaded, scaling with cores on TPU-VM-class hosts.
//
// Contract: returns 1 and fills out (n*c*25 bytes: 24 chars + ',' per
// cell, '\n' closing each row) iff EVERY cell formats to exactly 24
// characters. Any other width (negatives, nan/inf, 3-digit exponents)
// aborts with 0 and the caller falls back to np.savetxt — structural
// parity is enforced per cell, digit parity is pinned by tests.
//
// Built via g++ -O3 -shared -fPIC into the package's _build/ at first use
// (timed_design_tpu_torch/io/fast_fmt.py).
#include <cstddef>
#include <cstdio>
#include <thread>
#include <vector>
#include <atomic>
#include <locale.h>

namespace {

// snprintf honors the process LC_NUMERIC: an embedding application that
// later calls setlocale(LC_NUMERIC, "de_DE") would make "%.18e" emit a
// comma decimal point — still exactly 24 chars, so the width check alone
// would pass while silently corrupting the CSV. Pin the "C" locale
// per-thread (uselocale is thread-local) for the duration of formatting.
locale_t c_numeric_locale() {
    static locale_t loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
    return loc;
}

// formats rows [lo, hi); sets *ok to false on any width violation
void fmt_rows(const double* vals, size_t c, size_t lo, size_t hi,
              char* out, std::atomic<bool>* ok) {
    locale_t pinned = c_numeric_locale();
    locale_t prev = pinned ? uselocale(pinned) : (locale_t)0;
    char buf[40];
    for (size_t i = lo; i < hi && ok->load(std::memory_order_relaxed); ++i) {
        const double* row = vals + i * c;
        char* dst = out + i * c * 25;
        for (size_t j = 0; j < c; ++j) {
            int w = snprintf(buf, sizeof buf, "%.18e", row[j]);
            if (w != 24) {
                ok->store(false, std::memory_order_relaxed);
                if (prev) uselocale(prev);
                return;
            }
            for (int k = 0; k < 24; ++k) dst[k] = buf[k];
            dst[24] = (j + 1 == c) ? '\n' : ',';
            dst += 25;
        }
    }
    if (prev) uselocale(prev);
}

}  // namespace

extern "C" int fmt_e18_rows(const double* vals, size_t n, size_t c,
                            char* out, int n_threads) {
    if (n == 0 || c == 0) return 0;
    std::atomic<bool> ok(true);
    if (n_threads <= 1 || n < 64) {
        fmt_rows(vals, c, 0, n, out, &ok);
    } else {
        size_t per = (n + n_threads - 1) / n_threads;
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; ++t) {
            size_t lo = t * per;
            if (lo >= n) break;
            size_t hi = lo + per < n ? lo + per : n;
            ts.emplace_back(fmt_rows, vals, c, lo, hi, out, &ok);
        }
        for (auto& t : ts) t.join();
    }
    return ok.load() ? 1 : 0;
}
