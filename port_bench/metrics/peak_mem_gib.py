"""`torch.cuda.max_memory_allocated()` over the window, after a reset at its
start; the fullest card's."""

UNIT = "GiB"
SOURCE = "device_trace"


def read(ctx):
    return ctx.peak / 2 ** 30
