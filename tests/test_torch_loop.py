"""The port's ``make_train_step`` against the JAX package's on the CPU for
h2o-danube3-4b (microbatch 0 and 2, and int8 gradient compression) and
deepseek-moe-16b (microbatch 0 and 2), at SMOKE in float32 with the JAX
weights and the same numpy batches (``tests/torch_loop_cases.py`` holds
the check and its bars)."""
import pytest

from torch_loop_cases import check_step


@pytest.mark.parametrize("arch,microbatch,compression", [
    ("h2o-danube3-4b", 0, "none"), ("h2o-danube3-4b", 2, "none"),
    ("h2o-danube3-4b", 2, "int8"), ("deepseek-moe-16b", 0, "none"),
    ("deepseek-moe-16b", 2, "none")])
def test_train_step_matches_jax(arch, microbatch, compression):
    check_step(arch, microbatch, compression)
