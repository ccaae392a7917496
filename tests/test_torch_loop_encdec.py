"""The port's ``make_train_step`` against the JAX package's on the CPU for
zamba2-2.7b's Mamba2 hybrid and whisper-small's encoder-decoder
(microbatch 0 and 2), at SMOKE in float32 with the JAX weights and the
same numpy batches (``tests/torch_loop_cases.py`` holds the check and
its bars)."""
import pytest

from torch_loop_cases import check_step


@pytest.mark.parametrize("arch,microbatch", [
    ("zamba2-2.7b", 0), ("zamba2-2.7b", 2), ("whisper-small", 0),
    ("whisper-small", 2)])
def test_train_step_matches_jax(arch, microbatch):
    check_step(arch, microbatch, "none")
