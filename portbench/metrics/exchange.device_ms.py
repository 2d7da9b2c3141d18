"""exchange.device_ms: device time a profiled step of the operations
launched inside the engine's "bucket <i>" ranges, the largest over the
ranks."""


def read(record: dict):
    ranks = record.get("profile")
    if not ranks or not any(r["bucket_us"] for r in ranks):
        return None
    return max(r["bucket_us"] / r["steps"] for r in ranks) / 1e3
