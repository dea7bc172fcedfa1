"""launches_per_inner: device operations (kernels, copies, sets; those
replayed from CUDA graphs included) of the traced solves over their CG
iterations."""


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    inners = sum(s["inners"] for s in tr["solves"])
    return tr["launches"] / inners if inners and tr["launches"] else None
