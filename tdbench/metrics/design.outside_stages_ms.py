"""The mean of each answered /design request's client latency less the
sum of its stages in `timings_s` (parse, voxelisation, prediction,
sampling): the wait in queues, JSON and HTTP."""

STAGES = ("parse", "voxelisation", "prediction", "sampling")


def read(record):
    done = [r for r in record.get("requests", []) if r.get("status") == 200]
    if not done:
        return None
    return 1e3 * sum(r["latency"] - sum(r["timings_s"].get(k, 0.0) for k in STAGES)
                     for r in done) / len(done)
