"""Inputs shared by the port's sharded-runtime tests and the JAX package's
sharded runtime in a subprocess (``test_torch_sharded.py``): numpy only,
drawn from seeds, so both interpreters build the same grids and frames.

``ragged_grids`` and ``frame_trace`` are ``tests/test_sharded.py``'s
ragged fleet (with an empty group) and trace (per-camera static repeats),
the trace with one all-static step added; ``drift_scene`` builds the
scene, offline result and warmed ``DriftAdapter`` of a re-solve from
either package's modules."""
import numpy as np

TILE = 8
CHANNELS = (4, 6)
STEPS = 5                      # the trace's steps, the all-static one too
STATIC_STEP = 3                # trace[3] repeats trace[2]
THRESHOLDS = {"zero": 0.0,
              # per camera: group 0's second camera and group 3's first
              # never refresh at these unit-scale frames
              "per_camera": {0: np.array([0.0, 1e9]),
                             3: np.array([1e9, 0.0])}}
DRIFT_GID = 1                  # the group a DriftAdapter re-solves
DRIFT_SCENE = dict(duration_s=25, seed=2)
DRIFT_PROFILE, DRIFT_WARM = 150, (150, 200)


def ragged_grids():
    rng = np.random.default_rng(0)
    return {0: [rng.random((3, 4)) < 0.6, rng.random((2, 2)) < 0.9],
            1: [rng.random((4, 3)) < 0.5],
            2: [np.zeros((2, 3), bool)],          # empty group
            3: [rng.random((3, 3)) < 0.7, np.ones((1, 4), bool)]}


def frame_trace(grids, steps=STEPS, seed=7, tile=TILE):
    """Frames of the grids' extent with per-camera static repeats; step
    ``STATIC_STEP`` repeats the step before it whole (all-static)."""
    rng = np.random.default_rng(seed)
    out, prev = [], None
    for s in range(steps - 1):
        f = {}
        for gid, gs in grids.items():
            f[gid] = [prev[gid][i] if (s > 0 and (s + gid + i) % 3 == 0)
                      else rng.random((g.shape[0] * tile, g.shape[1] * tile,
                                       3)).astype(np.float32)
                      for i, g in enumerate(gs)]
        prev = f
        out.append(f)
    out.insert(STATIC_STEP, out[STATIC_STEP - 1])
    return out


def per_gid(frames_list):
    return [{g: list(fs) for g, fs in f.items()} for f in frames_list]


def drift_scene(scene_mod, pipe_mod, drift_mod):
    """(scene, offline result, DriftAdapter warmed on frames
    ``DRIFT_WARM``) of one package, built the same way in both."""
    scene = scene_mod.generate_scene(scene_mod.SceneConfig(**DRIFT_SCENE))
    off = pipe_mod.run_offline(scene, pipe_mod.OfflineConfig(
        profile_frames=DRIFT_PROFILE, solver="greedy"))
    ad = drift_mod.DriftAdapter(scene, off,
                                drift_mod.DriftConfig(confirm_frames=10 ** 9))
    for t in range(*DRIFT_WARM):
        ad.observe(t, scene.detections[t])
    return scene, off, ad


def drift_grids(ad, others):
    """The fleet of the drift case: ``others`` plus group ``DRIFT_GID``,
    the adapter's cameras at their cell grids (one detector tile a
    cell)."""
    grids = {g: [a.copy() for a in gs] for g, gs in others.items()}
    grids[DRIFT_GID] = [ad.cam_grids[c.cam_id].copy() for c in ad.cameras]
    return dict(sorted(grids.items()))


def drift_frames(grids, steps=3, seed=11, tile=TILE):
    """Fresh frames for group ``DRIFT_GID`` every step; the other groups'
    frames hold still."""
    rng = np.random.default_rng(seed)

    def draw(gs):
        return [rng.random((a.shape[0] * tile, a.shape[1] * tile, 3))
                .astype(np.float32) for a in gs]

    still = {g: draw(gs) for g, gs in grids.items() if g != DRIFT_GID}
    return [{g: draw(gs) if g == DRIFT_GID else still[g]
             for g, gs in grids.items()} for _ in range(steps)]


# ---------------------------------------------------------------------------
# recording a run the same way in both packages
# ---------------------------------------------------------------------------

def to_np(x):
    """A map as numpy: a tensor copied through the host (the port's maps
    are views of a canvas the next step overwrites), arrays as they
    are."""
    return x.detach().cpu().numpy().copy() if hasattr(x, "detach") \
        else np.asarray(x)


def maps_np(maps):
    return {g: [to_np(m) for m in ms] for g, ms in maps.items()}


def cache_counters(cache):
    return dict(steps=cache.steps, cold_steps=cache.cold_steps,
                launched_tiles=cache.launched_tiles,
                total_tiles=cache.total_tiles,
                canvas_bytes_last=cache.canvas_bytes_last,
                canvas_bytes_total=cache.canvas_bytes_total,
                invalidations=cache.invalidations,
                shard_invalidations=np.asarray(cache.shard_invalidations),
                valid=np.asarray(cache.valid),
                epoch=None if cache.epoch_np is None
                else np.asarray(cache.epoch_np))


def run_steps(step_fn, rt, cache, frames_list, threshold=0.0):
    """[(maps as numpy, dispatch dict, stats)] of ``step_fn`` (the
    package's ``sharded_fleet_step``) over ``frames_list``."""
    out = []
    for f in frames_list:
        maps, counts, stats = step_fn(rt, f, cache, threshold)
        out.append((maps_np(maps), dict(counts), stats))
    return out


def drift_run(pkg, det, mesh, others, first_listener=None):
    """The drift case in one package (``pkg``: a namespace with
    ``scene``, ``pipeline``, ``drift``, ``faults``, ``ShardedSuperlaunch``
    and ``sharded_fleet_step``): the fleet with group ``DRIFT_GID`` on a
    warmed adapter wired through ``wire_shard_invalidation``, two steps,
    a failover re-solve of the busiest camera, a step, a drift re-solve,
    a step.  ``first_listener(cache)``, when given, is a mask listener
    that runs before the wired one.  Returns (steps, the runtime's final
    grids, cache counters, the owning shard, the runtime)."""
    _, _, ad = drift_scene(pkg.scene, pkg.pipeline, pkg.drift)
    grids = drift_grids(ad, others)
    frames = drift_frames(grids)
    rt = pkg.ShardedSuperlaunch(det, grids, mesh)
    cache = rt.make_cache()
    if first_listener is not None:
        ad.add_mask_listener(lambda _: first_listener(cache))
    pkg.drift.wire_shard_invalidation({DRIFT_GID: ad}, cache, runtime=rt)
    steps = run_steps(pkg.sharded_fleet_step, rt, cache, frames[:2])
    occ = ad.occupancy_by_camera()
    pkg.faults.failover_resolve(ad, [max(occ, key=occ.get)],
                                t=DRIFT_WARM[1])
    steps += run_steps(pkg.sharded_fleet_step, rt, cache, frames[2:3])
    ad._resolve(DRIFT_WARM[1] + 1)
    steps += run_steps(pkg.sharded_fleet_step, rt, cache, frames[1:2])
    return (steps, {g: [np.asarray(a) for a in gs]
                    for g, gs in rt.grids.items()},
            cache_counters(cache), cache.owner_shard(DRIFT_GID), rt)
