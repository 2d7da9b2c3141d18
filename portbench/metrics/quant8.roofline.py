"""quant8.roofline: the int8 wire's kernels against their bytes bound:
the sum over the profiled launches of (bytes read once and written once /
HBM bandwidth) over their summed device time, in percent. Each launch's
bytes come from its bucket's size (`quant8_bytes`)."""

from portbench import peaks, quant8_bytes


def read(record: dict):
    ranks = record.get("profile")
    sizes = record.get("bucket_sizes")
    bound = took = 0.0
    for r in ranks or ():
        for name, bucket, us in r["quant8"]:
            if bucket is None:
                continue
            n_shard, n_full = sizes[bucket]
            b = quant8_bytes.kernel_bytes(name, n_shard, n_full)
            if b is None:
                continue
            bound += b / peaks.HBM_BYTES_PER_S
            took += us / 1e6
    if took <= 0:
        return None
    return 100.0 * bound / took
