"""95th percentile of the time from a batch's pull by the pipeline to the
return of its records, over the window's batches that the traced stretch
and the profiler's start and stop left alone (their count on the run's
stderr). In a closed loop at capacity the tail is mostly the queue: a
stall shows here before the rate moves."""


def read(layer):
    return layer.get("batch_p95_ms")
