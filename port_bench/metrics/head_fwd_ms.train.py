"""Mean device time of the decode head's forward a train step: CUDA events from
hooks on `model.decode_head`."""

from port_bench import readers

UNIT = "ms"
LAYER = "head"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.mean_ms(ctx, "head", "train")
