"""cg_roofline: the traced solves' CG iterations times the least time one
iteration needs at the configuration's shapes (``portbench/roofline.py``:
operands read once and vectors written once, over the card's published
bandwidth or float32 rate, whichever binds), as a share of the device's busy
time in those solves.  Nothing for a card the peak table lacks."""


def read(record):
    tr = record.get("trace")
    bound = record.get("roofline")
    if not tr or not bound or tr["busy_s"] <= 0:
        return None
    inners = sum(s["inners"] for s in tr["solves"])
    return 100.0 * inners * bound["seconds"] / tr["busy_s"] if inners else None
