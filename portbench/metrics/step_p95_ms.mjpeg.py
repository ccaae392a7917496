"""The 95th percentile of the window's step times (ms): each step on the
host clock from the hand-over of its frames to its maps ready after a
synchronize, over the steps the profiler was off for (a traced run
profiles a stretch of its window, and those steps run slower).  Kept
beside ``frames_per_s`` in the MJPEG cell, where the card idles over half
the traced window, so the tail is paced by the host."""
import numpy as np


def read(run):
    traced = set(run.traced_i)
    lat = [s for i, s in enumerate(run.step_s) if i not in traced]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
