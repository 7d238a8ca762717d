"""Host seconds in the MAPQ cap's calls in the window: the harness's
spans around GiraffeMapper.begin_mapq_caps and apply_mapq_caps, summed
over threads, in microseconds a read."""


def read(layer):
    s = layer.get("spans", {})
    if "begin_mapq_caps" not in s or not layer.get("reads"):
        return None
    return 1e6 * (s["begin_mapq_caps"] + s.get("apply_mapq_caps", 0.0)) \
        / layer["reads"]
