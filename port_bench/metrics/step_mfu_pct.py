"""The whole step's share of the card's peak: the models' FLOP of every
call of the window (counted on the plain reference, `work/flops.py`) per
second of the window, over the published peak of the cell's math
(`work/peaks.py`; the card's power limit is printed beside it)."""


def read(run):
    if "flops" not in run.window or run.peak_flops is None:
        return None
    return 100.0 * run.window["flops"] / run.window["seconds"] / run.peak_flops
