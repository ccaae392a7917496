"""The model-axis route (tensor and expert parallelism) of the
qwen3-moe-235b-a22b and deepseek-moe-16b SMOKE configs on 2 and 4 gloo
ranks against the single-process step -- the expert-parallel route at
E/tp = 4 and 2 -- with the cases and bars of ``tests/torch_tp_cases.py``;
and the expert-parallel forward against the JAX package's ``shard_map``
route on forced host devices."""
import pytest

from repro_torch.configs import get_config
from test_torch_dist import _run_worker
from torch_tp_cases import check_arch, run_archs


ARCHS = ["qwen3-moe-235b-a22b", "deepseek-moe-16b"]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """(world, each arch's variants on ``world`` gloo ranks), one worker
    subprocess a world size."""
    world = request.param
    return world, run_archs(tmp_path_factory.mktemp(f"ranks{world}"),
                            ARCHS, world)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_matches_single_process(ranks, arch):
    world, res = ranks
    check_arch(res[arch], arch, world)


JAX_EP = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.distributed.shardings import make_dist
from repro.models.moe import moe_layer
inp = np.load("{inputs}")
cfg = get_config("deepseek-moe-16b", smoke=True).replace(
    capacity_factor={cf}, dtype="float32")
out = {{}}
for i, shape in enumerate({meshes}):
    dist = make_dist(jax.make_mesh(tuple(shape), ("data", "model")))
    assert dist.manual_moe
    y, aux, dropped = jax.jit(lambda *a: moe_layer(*a, cfg, dist))(
        *(jnp.asarray(inp[k]) for k in ("x", "rw", "wg", "wu", "wd")))
    out[f"y{{i}}"] = np.asarray(y)
    out[f"aux{{i}}"] = np.asarray(aux)
    out[f"dropped{{i}}"] = np.asarray(dropped)
np.savez("{out}", **out)
"""


def test_ep_forward_matches_jax_shard_map(tmp_path):
    """deepseek-moe-16b SMOKE's ``moe_layer`` (E = 8, a capacity factor of
    0.5 so that tokens drop) on 4 gloo ranks, meshes (2, 2) and (1, 4)
    (E/tp = 4 and 2), against the JAX package's expert-parallel
    ``shard_map`` on 4 forced host devices, the same meshes and inputs: y
    and the dropped share (each rank's share of its own experts' drops,
    meaned over every rank, as the JAX route's) within 1e-5, the aux
    loss too."""
    import numpy as np
    import torch
    from test_distributed import _run
    cfg = get_config("deepseek-moe-16b", smoke=True)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    rng = np.random.default_rng(0)
    inp = {"x": rng.normal(size=(4, 32, D)) * 0.3,
           "rw": rng.normal(size=(D, E)) * 0.2,
           "wg": rng.normal(size=(E, D, F)) * 0.05,
           "wu": rng.normal(size=(E, D, F)) * 0.05,
           "wd": rng.normal(size=(E, F, D)) * 0.05}
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    meshes = [[2, 2], [1, 4]]
    np.savez(tmp_path / "inputs.npz", **inp)
    _run(JAX_EP.format(inputs=tmp_path / "inputs.npz", cf=0.5,
                       meshes=meshes, out=tmp_path / "jax.npz"),
         devices=4, timeout=300)
    want = np.load(tmp_path / "jax.npz")
    torch.save({k: torch.from_numpy(v) for k, v in inp.items()},
               tmp_path / "inputs.pt")
    (tmp_path / "port").mkdir()
    got = _run_worker("ep", tmp_path / "port", world=4,
                      arch="deepseek-moe-16b",
                      overrides={"capacity_factor": 0.5},
                      inputs=str(tmp_path / "inputs.pt"), meshes=meshes)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g["y"].numpy(), want[f"y{i}"], atol=1e-5)
        assert abs(g["dropped"] - float(want[f"dropped{i}"])) <= 1e-5
        assert abs(g["aux"] - float(want[f"aux{i}"])) <= 1e-5
        assert g["dropped"] > 0
