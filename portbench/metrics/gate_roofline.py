"""The delta gate's (``tile_delta_gate_canvas``, B1) share of its roofline
(%): the least time for the bytes each of its launches must move -- every
covered pixel of the frames and of the reference once, the rows read and
the stats rows written, at the card's memory bandwidth -- over its device
time in the traced steps."""
from portbench import yardstick


def read(run):
    tr = run.trace
    peak = yardstick.peaks(run.device_name)
    if tr is None or peak is None:
        return None
    gate_s = sum(s for name, s in tr.step_by_name.items()
                 if yardstick.kernel_role(name) == "gate")
    launches = sum(n for name, n in tr.step_calls.items()
                   if yardstick.kernel_role(name) == "gate")
    if gate_s <= 0 or launches == 0:
        return None
    least = yardstick.least_s(
        yardstick.gate_bytes(run.grids, run.config["tile_px"]), 0, peak)
    return 100.0 * launches * least / gate_s
