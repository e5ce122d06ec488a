"""``torch.cuda.max_memory_allocated()`` from the start of set-up to the
end of the window (the captured graph's pool included), in GiB."""


def read(ctx):
    return ctx["memory_peak_bytes"] / 2 ** 30
