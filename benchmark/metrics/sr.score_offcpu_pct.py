"""Share of the score stage's wall seconds in the window that its thread
spent off the CPU (waiting for the interpreter lock, a lock, the device
or a core): 100 x (score - score.cpu) / score, from the port's
stage_seconds. None where the program has no score.cpu counter."""


def read(layer):
    d = layer.get("stage_delta", {})
    wall, cpu = d.get("score"), d.get("score.cpu")
    if wall is None or cpu is None or not wall > 0:
        return None
    return 100.0 * (wall - cpu) / wall
