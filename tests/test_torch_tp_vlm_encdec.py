"""The model-axis route (tensor parallelism) of the internvl2-26b and
whisper-small SMOKE configs -- the patch stream beside the vocabulary,
the encoder, the decoder's cross-attention -- on 2 and 4 gloo ranks
against the single-process step, with the cases and bars of
``tests/torch_tp_cases.py``."""
import pytest

from torch_tp_cases import check_arch, run_archs


ARCHS = ["internvl2-26b", "whisper-small"]


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
