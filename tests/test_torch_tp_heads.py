"""A model axis whose column split of ``wq`` cuts heads -- whisper-small
on the production mesh's 16-wide axis (12 heads), here its SMOKE config
with one query and one KV head of 16 over 2 gloo ranks: every rank
gathers the attention's projections whole and runs it whole
(``forward._heads_whole``).  Training (tp and fsdp, ``make_train_step``
and ``train()``) against the single-process step with the bars of
``tests/torch_tp_cases.py``; serving (prefill, teacher-forced decode,
the cache shards -- the sequence over the model axis -- and greedy
decode through the model API) against the one-rank path with those of
``tests/torch_tp_serve_cases.py``."""
import pytest

import torch_tp_serve_cases as serve_cases
from torch_tp_cases import run_arch

CASE = "whisper-small:one_head"


def test_training_with_heads_cut_matches_single_process(tmp_path):
    run_arch(tmp_path, serve_cases.arch_of(CASE), 2,
             overrides=serve_cases.CASES[CASE]["overrides"])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return serve_cases.run_cases(tmp_path_factory.mktemp("heads"), [CASE],
                                 2)


@pytest.mark.parametrize("what", ["logits", "caches", "tokens"])
def test_serving_with_heads_cut_matches_single_process(served, what):
    serve_cases.check_case(served, CASE, 2, what)
