"""Seconds the pipeline's seeder spent blocked on a full queue downstream
in the window: the port's span wait.score_out, in microseconds a read.
None where the program has no such span."""


def read(layer):
    d = layer.get("stage_delta", {}).get("wait.score_out")
    if d is None or not layer.get("reads"):
        return None
    return 1e6 * d / layer["reads"]
