"""Serving over a model axis on 2 and 4 gloo ranks against the
single-process path, at SMOKE in float32: h2o-danube3-4b (a window
ring past its 32 slots; once with ``decode_grouped_attn``) and
gemma3-27b (local rings, global caches; once with a window of 30, whose
rings every rank holds whole at tp 4), with the
cases and bars of ``tests/torch_tp_serve_cases.py``."""
import pytest

from torch_tp_serve_cases import check_case, run_cases


CASES = ["h2o-danube3-4b", "h2o-danube3-4b:grouped", "gemma3-27b",
         "gemma3-27b:window30"]


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
