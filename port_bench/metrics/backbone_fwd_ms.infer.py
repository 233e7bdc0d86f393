"""Mean device time of the backbone's forward a request, as
`backbone_fwd_ms.train`."""

from port_bench import readers

UNIT = "ms"
LAYER = "backbone"
MOVES = "infer_img_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.mean_ms(ctx, "backbone", "infer")
