"""Device ms per epoch of every operation that is not one of the port's
kernels (``kernel_names.json``): cuBLAS GEMMs, PyTorch's gathers,
elementwise and reduction kernels, the optimizer, copies."""

from benchmark.readers import is_port_kernel


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace["epochs"]:
        return None
    spent = sum(s for name, s in trace["kernel_s"].items()
                if not is_port_kernel(name))
    return 1e3 * spent / trace["epochs"]
