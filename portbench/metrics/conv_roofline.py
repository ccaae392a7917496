"""The conv chain's (entry, stack and scatter kernels: B2, B3, B4) share
of its roofline (%): the least time of the tiles the traced steps' inputs
need (the benchmark's own count from its traffic), each at the larger of
its convolutions' FLOPs over the float32 peak and its bytes over the
memory bandwidth, over the three kernels' device time."""
from portbench import yardstick


def read(run):
    tr = run.trace
    peak = yardstick.peaks(run.device_name)
    if tr is None or peak is None or not run.traced_needed:
        return None
    conv_s = sum(s for name, s in tr.step_by_name.items()
                 if yardstick.kernel_role(name) == "conv")
    if conv_s <= 0:
        return None
    flops, nbytes = yardstick.conv_chain_work(run.config["detector"],
                                              run.config["tile_px"])
    least = sum(run.traced_needed) * yardstick.least_s(nbytes, flops, peak)
    return 100.0 * least / conv_s
