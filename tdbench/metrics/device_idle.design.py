"""The traced window's share in which no kernel, copy or set ran on the
device: 1 - busy / window, busy the union of the device intervals."""


def read(record):
    if record.get("kind") != "design" or not record.get("busy_s") or not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
