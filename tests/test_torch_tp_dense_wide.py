"""The model-axis route (tensor parallelism) of the mistral-nemo-12b and
deepseek-67b SMOKE configs on 2 and 4 gloo ranks against the
single-process step, with the cases and bars of
``tests/torch_tp_cases.py``."""
import pytest

from torch_tp_cases import check_arch, run_archs


ARCHS = ["mistral-nemo-12b", "deepseek-67b"]


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
