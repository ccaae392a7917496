"""The whole step's share of the card's float32 peak (%): the detector
FLOPs the traced steps' inputs need (convolutions and head on every tile
the benchmark counts as needed) over the traced window's length times
the float32 peak outside the tensor cores."""
from portbench import yardstick


def read(run):
    tr = run.trace
    peak = yardstick.peaks(run.device_name)
    if tr is None or peak is None or not run.traced_needed:
        return None
    flops = sum(run.traced_needed) * yardstick.detector_flop_per_tile(
        run.config["detector"], run.config["tile_px"])
    return 100.0 * flops / (tr.window_s * peak["f32_flop_per_s"])
