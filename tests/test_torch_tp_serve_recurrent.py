"""Serving over a model axis on 2 and 4 gloo ranks against the
single-process path, at SMOKE in float32: rwkv6-7b (the wkv
state by heads), zamba2-2.7b (Mamba2's states whole, the shared
attention's caches) and whisper-small (the decoder's self and cross
caches, through ``model.prefill`` and ``decode_step``), with the
cases and bars of ``tests/torch_tp_serve_cases.py``."""
import pytest

from torch_tp_serve_cases import check_case, run_cases


CASES = ["rwkv6-7b", "zamba2-2.7b", "whisper-small"]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """(world, every case's results on ``world`` gloo ranks), one worker
    subprocess a world size."""
    world = request.param
    return world, run_cases(tmp_path_factory.mktemp(f"serve{world}"),
                            CASES, world)


@pytest.mark.parametrize("what", ["logits", "caches", "tokens"])
@pytest.mark.parametrize("case", CASES)
def test_serving_over_model_axis_matches_single_process(ranks, case, what):
    world, res = ranks
    check_case(res, case, world, what)
