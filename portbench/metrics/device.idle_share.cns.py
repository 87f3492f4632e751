"""1 - device-busy time / wall of the traced window, in a consensus
cell."""


def read(w):
    if w.trace is None or w.work_unit != "kbp" or w.trace.window_s <= 0:
        return None
    return 1.0 - w.trace.busy_s / w.trace.window_s
