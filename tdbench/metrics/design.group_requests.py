"""The mean over answered /design requests of the size of the coalesced
group each rode in (`timings_s.group_requests`)."""


def read(record):
    done = [r for r in record.get("requests", []) if r.get("status") == 200]
    if not done:
        return None
    return sum(r["timings_s"]["group_requests"] for r in done) / len(done)
