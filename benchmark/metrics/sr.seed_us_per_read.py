"""Host seconds of seeding in the window: the port's span score.seed
(GiraffeMapper.prepare_batch's minimizer seeding of both mates, inside
the score stage), summed over threads, in microseconds a read. None
where the program has no such span."""


def read(layer):
    d = layer.get("stage_delta", {}).get("score.seed")
    if d is None or not layer.get("reads"):
        return None
    return 1e6 * d / layer["reads"]
