"""Mean device time of `LayerDecayAdamW.step` a train step (clip and update):
CUDA events around the call."""

from port_bench import readers

UNIT = "ms"
LAYER = "optimizer"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.mean_ms(ctx, "optimizer", "train")
