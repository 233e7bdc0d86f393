"""Mean device time of the backbone's forward a train step: CUDA events on the
stream from forward pre/post hooks on `model.backbone`."""

from port_bench import readers

UNIT = "ms"
LAYER = "backbone"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.mean_ms(ctx, "backbone", "train")
