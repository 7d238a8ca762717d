"""Host seconds of the paired pipeline's dev_wait stage in the window (the
port's PairedGiraffeMapper.stage_seconds["dev_wait"], summed over the stage's
threads), in microseconds a read."""


def read(layer):
    d = layer.get("stage_delta", {}).get("dev_wait")
    if d is None or not layer.get("reads"):
        return None
    return 1e6 * d / layer["reads"]
