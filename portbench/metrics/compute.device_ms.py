"""compute.device_ms: device time a profiled step of every operation
launched outside the exchange's bucket ranges (model, loss, clip,
optimizer), the largest over the ranks."""


def read(record: dict):
    ranks = record.get("profile")
    if not ranks or not any(r["other_us"] for r in ranks):
        return None
    return max(r["other_us"] / r["steps"] for r in ranks) / 1e3
