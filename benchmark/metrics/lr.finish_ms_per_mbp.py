"""Host seconds of LongReadMapper.map_batch_encoded outside its passes in
the window (winners, MAPQ, reference positions, the GAM encode), in
milliseconds a million read bases."""


def read(layer):
    s = layer.get("spans", {})
    if "map_batch" not in s or "passes" not in s or not layer.get("bases"):
        return None
    return 1e3 * (s["map_batch"] - s["passes"]) / (layer["bases"] / 1e6)
