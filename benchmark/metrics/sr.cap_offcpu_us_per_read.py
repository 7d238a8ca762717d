"""Host seconds of the MAPQ cap in the window spent off the CPU and not
waiting for the card: the port's spans cap.begin and cap.apply less
their threads' CPU seconds, less cap.wait (the waits for the card's
events inside them), summed over threads, in microseconds a read. None
where the program has no such spans."""

KEYS = ("cap.begin", "cap.begin.cpu", "cap.apply", "cap.apply.cpu",
        "cap.wait")


def read(layer):
    d = layer.get("stage_delta", {})
    if any(k not in d for k in KEYS) or not layer.get("reads"):
        return None
    off = (d["cap.begin"] - d["cap.begin.cpu"] + d["cap.apply"]
           - d["cap.apply.cpu"] - d["cap.wait"])
    return 1e6 * off / layer["reads"]
