"""Host seconds in LongReadMapper._native_batch in the window (the chain,
link and stitch passes of either engine: the harness's span), in
milliseconds a million read bases."""


def read(layer):
    s = layer.get("spans", {}).get("passes")
    if s is None or not layer.get("bases"):
        return None
    return 1e3 * s / (layer["bases"] / 1e6)
