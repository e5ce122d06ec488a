"""The share of the traced window of whole blocks in which no operation ran
on the device, in %: 1 - (union of the device operations' intervals) /
window."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
