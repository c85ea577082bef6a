"""Share of the traced calls' own time (due to result) in which the card
ran nothing, %: the host boundary's share of a call. The gaps between
calls, which the fixed rate makes, are not counted."""


def read(r: dict):
    tr = r.get("trace")
    if not tr or not tr["call_wall_s"]:
        return None
    wall, busy = sum(tr["call_wall_s"]), sum(tr["call_busy_s"])
    return None if busy <= 0 else 100.0 * (1 - busy / wall)
