"""Host seconds of the paired pipeline's rescue stage in the window (the
port's PairedGiraffeMapper.stage_seconds["rescue"], summed over the stage's
threads), in microseconds a read."""


def read(layer):
    d = layer.get("stage_delta", {}).get("rescue")
    if d is None or not layer.get("reads"):
        return None
    return 1e6 * d / layer["reads"]
