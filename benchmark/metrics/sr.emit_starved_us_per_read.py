"""Seconds the pipeline's emitters spent idle for want of input in the
window: the port's span wait.emit_in, summed over the emitter threads,
in microseconds a read. None where the program has no such span."""


def read(layer):
    d = layer.get("stage_delta", {}).get("wait.emit_in")
    if d is None or not layer.get("reads"):
        return None
    return 1e6 * d / layer["reads"]
