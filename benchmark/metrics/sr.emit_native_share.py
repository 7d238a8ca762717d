"""Share of the rows the short-read pipeline emitted in the window whose
records the native record writer wrote (the port's counters
emit.rows_native and emit.rows_fallback in stage_seconds): native over
native plus fallback. None where the program keeps neither counter (a
build before the writer) or emitted no row."""


def read(layer):
    d = layer.get("stage_delta", {})
    native, fallback = d.get("emit.rows_native"), d.get("emit.rows_fallback")
    if native is None and fallback is None:
        return None
    total = (native or 0.0) + (fallback or 0.0)
    if not total > 0:
        return None
    return (native or 0.0) / total
