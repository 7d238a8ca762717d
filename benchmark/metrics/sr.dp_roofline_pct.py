"""The banded DP's least time over its device time, in %, over the calls
of the packed DP entry in the traced stretch: the least time from
roofline.dp_least_seconds (the recurrence's cells, whatever kernel
computes them), the device time that between CUDA events around each
of their kernel launches."""


def read(layer):
    dev, least = layer.get("dp_device_s"), layer.get("dp_least_s")
    if not dev or not least:
        return None
    return 100.0 * least / dev
