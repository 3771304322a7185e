"""The mean over answered /design requests of the `timings_s` stage
`sampling`, in ms."""


def read(record):
    done = [r for r in record.get("requests", []) if r.get("status") == 200]
    if not done:
        return None
    return 1e3 * sum(r["timings_s"]["sampling"] for r in done) / len(done)
