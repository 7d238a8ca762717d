"""Host seconds of the paired pipeline's score stage in the window (the
port's PairedGiraffeMapper.stage_seconds["score"], summed over the stage's
threads), in microseconds a read."""


def read(layer):
    d = layer.get("stage_delta", {}).get("score")
    if d is None or not layer.get("reads"):
        return None
    return 1e6 * d / layer["reads"]
