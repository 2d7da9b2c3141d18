"""device.idle: share of the profiled steps' wall time with no operation
on the card, in percent, the largest over the ranks. It holds the
profiler's own cost: the profiler slows the host's issue of every
operation, and the run's log sets the traced steps' wall time beside the
untraced window's median step."""


def read(record: dict):
    ranks = record.get("profile")
    if not ranks or not all(r["window_us"] > 0 for r in ranks):
        return None
    return max(100.0 * (1.0 - r["busy_us"] / r["window_us"]) for r in ranks)
