"""Fitness evaluations (swarms x particles x iterations) of every call of
the window, over the window's wall time."""


def read(run):
    return run.window["evals"] / run.window["seconds"]
