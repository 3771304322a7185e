// Parallel zlib inflate pool for the gzip chunks of HDF5 frame datasets:
// the port's copy of native/inflate_pool.cpp.
//
// The tree-layout loader (io/h5frames.py) reads the raw chunk bytes itself
// (io/hdf5.py) and hands a batch of them to this pool, which inflates each
// straight into its place in the batch buffer from N worker threads
// (HDF5's deflate filter writes standard zlib streams). A thread pool over
// Python's zlib scales poorly: every call allocates its output anew.
//
// zlib is not linked: `uncompress` is looked up in libz.so.1 when the pool
// is made, so the library builds with no zlib headers or development
// files; inflate_pool_create returns null when libz.so.1 cannot be loaded.
//
// Concurrency: all queue state (jobs/next/remaining/first_error) is guarded
// by one mutex; workers release it around the inflate only. The done signal
// is raised while holding the mutex so the waiter cannot miss it, and run()
// is serialized by run_mu so concurrent callers cannot corrupt each other's
// job state.
//
// Built with g++ -O3 -shared -fPIC at first use (timed_design_tpu_torch/
// io/fast_inflate.py).
#include <dlfcn.h>

#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// zlib's uncompress(): Bytef is unsigned char, uLong(f) unsigned long; Z_OK 0
using uncompress_fn = int (*)(unsigned char*, unsigned long*, const unsigned char*,
                              unsigned long);

struct Job {
    const uint8_t* src;
    size_t src_len;
    uint8_t* dst;
    size_t dst_len;
};

struct Pool {
    uncompress_fn uncompress;
    std::mutex run_mu;  // serializes whole run() calls
    std::mutex mu;      // guards everything below
    std::condition_variable cv_work, cv_done;
    std::vector<Job> jobs;
    size_t next = 0;
    int remaining = 0;
    int first_error = 0;  // 0 = ok, else job index + 1
    bool stop = false;
    std::vector<std::thread> workers;

    Pool(int n_threads, uncompress_fn fn) : uncompress(fn) {
        for (int i = 0; i < n_threads; ++i) {
            workers.emplace_back([this] { this->worker(); });
        }
    }

    ~Pool() {
        {
            std::lock_guard<std::mutex> g(mu);
            stop = true;
        }
        cv_work.notify_all();
        for (auto& t : workers) t.join();
    }

    bool inflate_one(const Job& j) const {
        unsigned long dlen = j.dst_len;
        int rc = uncompress(j.dst, &dlen, j.src, j.src_len);
        return rc == 0 && dlen == j.dst_len;
    }

    void worker() {
        std::unique_lock<std::mutex> g(mu);
        for (;;) {
            cv_work.wait(g, [&] { return stop || next < jobs.size(); });
            if (stop) return;
            const size_t i = next++;
            const Job job = jobs[i];
            g.unlock();
            const bool ok = inflate_one(job);
            g.lock();
            if (!ok && first_error == 0) first_error = static_cast<int>(i) + 1;
            if (--remaining == 0) cv_done.notify_all();  // under mu: no lost wakeup
        }
    }

    int run(const Job* js, int n) {
        if (n == 0) return 0;
        std::lock_guard<std::mutex> serial(run_mu);
        std::unique_lock<std::mutex> g(mu);
        jobs.assign(js, js + n);
        next = 0;
        remaining = n;
        first_error = 0;
        cv_work.notify_all();
        cv_done.wait(g, [&] { return remaining == 0; });
        // leave no stale work visible: next == jobs.size() == 0 for waiters
        jobs.clear();
        next = 0;
        return first_error;
    }
};

}  // namespace

extern "C" {

// A pool of n_threads workers, or null when libz.so.1 cannot be loaded.
void* inflate_pool_create(int n_threads) {
    void* z = dlopen("libz.so.1", RTLD_NOW | RTLD_LOCAL);
    if (z == nullptr) return nullptr;
    auto fn = reinterpret_cast<uncompress_fn>(dlsym(z, "uncompress"));
    if (fn == nullptr) return nullptr;
    if (n_threads < 1) n_threads = 1;
    return new Pool(n_threads, fn);
}

void inflate_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Inflate n_jobs zlib streams in parallel. Returns 0 on success, else the
// 1-based index of the first failing job. Thread-safe (calls serialize).
int inflate_pool_run(void* pool, const uint8_t** srcs, const size_t* src_lens,
                     uint8_t** dsts, const size_t* dst_lens, int n_jobs) {
    std::vector<Job> jobs(n_jobs);
    for (int i = 0; i < n_jobs; ++i) {
        jobs[i] = Job{srcs[i], src_lens[i], dsts[i], dst_lens[i]};
    }
    return static_cast<Pool*>(pool)->run(jobs.data(), n_jobs);
}

}  // extern "C"
