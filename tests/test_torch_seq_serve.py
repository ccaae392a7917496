"""The sequence split of a serving cache over the batch axes
(``kv_seq_shard``, the long-context decode cell's layout) on 2 and 4 gloo
ranks against the single-process path, at SMOKE in float32:
h2o-danube3-4b (a window ring past its 32 slots, split over the batch
ranks; once with one KV head, whose sequence on (2, 2) runs over
("data", "model") joined), gemma3-27b (local rings and a global cache,
KH 2), zamba2-2.7b (its shared attention's caches split, its Mamba2
states whole) and rwkv6-7b (no KV cache: its states whole on every
batch rank), at a batch of 1 on (2, 1), (2, 2) and (4, 1) meshes and of
2 on (2, 1), with the cases and bars of
``tests/torch_seq_serve_cases.py``."""
import pytest

from torch_seq_serve_cases import CASES, check_case, run_cases


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """(world, every case's results on ``world`` gloo ranks), one worker
    subprocess a world size."""
    world = request.param
    return world, run_cases(tmp_path_factory.mktemp(f"seq{world}"),
                            sorted(CASES), world)


@pytest.mark.parametrize("what", ["logits", "caches", "tokens"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_split_over_batch_axes_matches_single_process(ranks, case,
                                                               what):
    world, res = ranks
    check_case(res, case, world, what)
