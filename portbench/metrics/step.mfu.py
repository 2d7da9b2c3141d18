"""step.mfu: model FLOPs of every step in the timed window over (window
seconds x chips x the bf16 peak), in percent."""

from portbench import peaks


def read(record: dict):
    w = record["window"]
    if not w["steps"]:
        return None
    return 100.0 * w["steps"] * record["flops_per_step"] / (
        w["seconds"] * record["chips"] * peaks.BF16_FLOPS)
