"""The traffic generator: determinism per seed, frames remade from the
seed equal to the frames it advanced to, and the changes it reports
against a pixel-level diff and a hand count; the frozen tracks of the
benchmark's fleet against its masks."""
import json

import numpy as np
import pytest
import torch

import portbench_tiny as T
from portbench_tiny import one_thread  # noqa: F401
from portbench import yardstick
from portbench.traffic import CameraTraffic, mix, tracks_boxes

pytestmark = pytest.mark.usefixtures("one_thread")


def make(seed, tracks=None, **over):
    return CameraTraffic(dict(T.TRAFFIC, **over), T.CONFIG["camera_hw"],
                         tracks_boxes(tracks or T.tiny_tracks()), seed,
                         "cpu")


def run(tr, steps):
    out = []
    for t in range(steps):
        tr.advance(t)
        out.append([f.clone() for f in tr.frames])
    return out


def test_same_seed_same_frames_other_seed_other_frames():
    a, b = run(make(2 ** 31 + 7), 6), run(make(2 ** 31 + 7), 6)
    c = run(make(2 ** 31 + 8), 6)
    assert all(torch.equal(x, y) for fa, fb in zip(a, b)
               for x, y in zip(fa, fb))
    assert not all(torch.equal(x, y) for fa, fc in zip(a, c)
                   for x, y in zip(fa, fc))


def test_every_seed_gets_the_same_work():
    """The boxes, and so the changed tiles, are the tracks', not the
    seed's; other tracks move them."""
    other = T.tiny_tracks()
    for cam in other["cameras"]:
        for f in cam["boxes"]:
            f[1] += 1                       # vehicle 1 a pixel lower
    a, b, c = make(1), make(2 ** 40 + 3), make(1, tracks=other)
    for t in range(1, 12):
        assert a.changes(t)[1] == b.changes(t)[1]
    assert any(a.changes(t)[1] != c.changes(t)[1] for t in range(1, 12))


def test_frames_are_8_bit_values():
    for fs in run(make(5), 4):
        for f in fs:
            assert torch.equal(f, f.round()) and f.min() >= 0 \
                and f.max() <= 255


@pytest.mark.parametrize("gop", [1, 3])
def test_frame_at_remakes_every_step_bit_for_bit(gop):
    tr = make(123456789012, gop=gop)
    for t, fs in enumerate(run(tr, 8)):
        for c, f in enumerate(fs):
            assert torch.equal(tr.frame_at(c, t), f), (t, c)


def test_advance_takes_steps_in_order():
    tr = make(1)
    tr.advance(0)
    with pytest.raises(ValueError):
        tr.advance(2)


def test_keyframes_staggered():
    tr = make(1, gop=3)
    assert tr.keyframes(0).all()
    # camera c keyframes where (t + c) % 3 == 0
    assert [list(np.nonzero(tr.keyframes(t))[0]) for t in (1, 2, 3, 4)] \
        == [[], [1], [0], []]


def test_reported_changes_by_hand():
    """Vehicle 1 and 2 move, vehicle 3 stands: the changes are the old
    and new boxes of 1 and 2; where 2 goes, its old box alone; past the
    tracks' end, the first frame's boxes follow the last's."""
    tr = make(4)
    kf, rects = tr.changes(1)
    assert rects[0] == [(4, 2, 12, 16), (7, 7, 12, 16),
                        (20, 82, 14, 10), (20, 76, 14, 10)]
    assert tr.changes(3)[1][1] == [(10, 12, 12, 16), (13, 17, 12, 16),
                                   (20, 38, 14, 10)]
    assert tr.changes(T.N_FRAMES)[1][0][:2] == [(19, 27, 12, 16),
                                                (4, 2, 12, 16)]
    assert not tr.changes(0)[1][0] and tr.changes(0)[0].all()
    # a replay that starts 2 frames in: step 1 shows frame 3
    assert make(4, start_frame=2).changes(1)[1][1] == tr.changes(3)[1][1]


def test_reported_changes_cover_the_pixels_that_changed():
    """Tiles whose haloed window holds a changed pixel (a diff of the
    frames) are the tiles the reported rectangles hit, on every
    non-keyframe camera and step, past the tracks' end too."""
    tr = make(99, gop=4)
    frames = run(tr, 10)
    grids = T.grids()
    for t in range(1, 10):
        kf, rects = tr.changes(t)
        for c, g in enumerate(grids):
            if kf[c]:
                continue
            diff = (frames[t][c] != frames[t - 1][c]).any(-1).numpy()
            gh, gw = g.shape
            pad = np.zeros((gh * 16 + 2, gw * 16 + 2), bool)
            h, w = diff.shape
            pad[1:1 + h, 1:1 + w] = diff[:gh * 16, :gw * 16]
            truth = np.array([[pad[ty * 16:ty * 16 + 18,
                                   tx * 16:tx * 16 + 18].any()
                               for tx in range(gw)] for ty in range(gh)])
            hits = yardstick.window_hits(rects[c], g.shape, 16)
            assert (truth <= hits).all(), (t, c)
            assert np.array_equal(truth & g, hits & g), (t, c)


def test_positions_stay_in_frame_and_start_on_active_tiles():
    """The fleet's frozen tracks (the vehicles of the scenes the masks
    were solved on, after the profile): every box lies in its camera's
    frame, nearly every box meets the camera's RoI, and so do most
    vehicles' first boxes (one that enters at a frame's edge may start
    outside it)."""
    configs = T.BENCH / "configs"
    tracks = json.loads((configs / "crossroi_4x5.tracks.json").read_text())
    masks = json.loads((configs / "crossroi_4x5.masks.json").read_text())
    boxes = tracks_boxes(tracks)
    assert len(boxes) == len(masks["cameras"]) == 20
    cell = masks["cell_px"]
    on = first = total = total_first = 0
    for frames, cam in zip(boxes, masks["cameras"]):
        grid = np.array([[ch == "1" for ch in r] for r in cam["rows"]])
        assert len(frames) == tracks["frames"][1] - tracks["frames"][0]
        seen = set()
        for f in frames:
            v, y, x, h, w = f.T
            assert ((y >= 0) & (x >= 0) & (h >= 1) & (w >= 1)
                    & (y + h <= cam["height"])
                    & (x + w <= cam["width"])).all()
            for i in range(len(f)):
                meets = grid[y[i] // cell:(y[i] + h[i] - 1) // cell + 1,
                             x[i] // cell:(x[i] + w[i] - 1) // cell + 1].any()
                on += meets
                total += 1
                if v[i] not in seen:
                    seen.add(v[i])
                    first += meets
                    total_first += 1
    assert total > 10000
    assert on / total >= 0.95 and first / total_first >= 0.9


def test_mix_is_a_function_of_its_keys():
    assert mix(1, 2, 3) == mix(1, 2, 3)
    assert mix(1, 2, 3) != mix(1, 3, 2)
    assert mix(2 ** 64 + 5, 1) == mix(5, 1)
    a = mix(9, np.arange(4)[:, None], np.arange(3)[None, :])
    assert a.shape == (4, 3) and len(set(a.ravel().tolist())) == 12
