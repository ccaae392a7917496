"""The launch bucket's waste (%): sum(launched) / sum(computed) - 1 over
the window's steps, from the program's ``ReuseStats``: the rows the
power-of-two bucket pads a compact set with."""


def read(run):
    computed = sum(s[1] for s in run.steps)
    if computed == 0:
        return None
    return 100.0 * (sum(s[2] for s in run.steps) / computed - 1.0)
