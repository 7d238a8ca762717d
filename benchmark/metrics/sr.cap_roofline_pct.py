"""The MAPQ cap's least time over its device time, in %, over the calls
of ops/cuda_mapqcap.mapq_cap in the traced stretch: the least time from
roofline.cap_least_seconds (the function's least work), the device time
that between CUDA events around each of their kernel launches."""


def read(layer):
    dev, least = layer.get("cap_device_s"), layer.get("cap_least_s")
    if not dev or not least:
        return None
    return 100.0 * least / dev
