"""Share of the traced stretch in which no operation ran on the card:
100 x (1 - the union of the kernels', copies' and sets' intervals over the
stretch's wall time), from torch.profiler's device trace."""


def read(layer):
    busy, wall = layer.get("busy_s"), layer.get("trace_window_s")
    if busy is None or not wall:
        return None
    return 100.0 * (1.0 - busy / wall)
