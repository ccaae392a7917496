"""The model-axis route of the rwkv6-7b and zamba2-2.7b SMOKE configs --
RWKV6's heads, Mamba2's gathered ``in_proj``, zamba2's shared attention
-- on 2 and 4 gloo ranks against the single-process step, with the
cases and bars of ``tests/torch_tp_cases.py``."""
import pytest

from torch_tp_cases import check_arch, run_archs


ARCHS = ["rwkv6-7b", "zamba2-2.7b"]


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
