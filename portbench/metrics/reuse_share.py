"""The share of active tiles the delta gate let the window's steps reuse
(%): 1 - sum(computed) / sum(active tiles), from the program's
``ReuseStats`` of each step."""


def read(run):
    total = sum(s[0] for s in run.steps)
    if total == 0:
        return None
    return 100.0 * (1.0 - sum(s[1] for s in run.steps) / total)
