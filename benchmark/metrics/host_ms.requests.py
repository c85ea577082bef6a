"""Mean over the traced calls of the call's wall time less the card's busy
time inside it, ms a request: upload, conversions, launches and readback
that the card does not overlap."""


def read(r: dict):
    tr = r.get("trace")
    if not tr or not tr["call_wall_s"]:
        return None
    gaps = [w - b for w, b in zip(tr["call_wall_s"], tr["call_busy_s"])]
    return 1e3 * sum(gaps) / len(gaps)
