"""The whole epoch's least time on the chip (``readers.epoch_ops`` with the
attention fused, the least the model needs on any layout) over the device
busy time per epoch, in %."""

from benchmark import work
from benchmark.readers import epoch_ops


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["busy_s"] <= 0.0:
        return None
    least_s = work.least_ms(epoch_ops(ctx, "fused"),
                            ctx["cfg"]["dtype"]) * 1e-3
    return 100.0 * least_s * trace["epochs"] / trace["busy_s"]
