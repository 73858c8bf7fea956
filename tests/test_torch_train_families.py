"""The port's training forward and gradients against the JAX reference for
the hybrid (recurrentgemma-2b), ssm (mamba2-2.7b) and audio
(whisper-large-v3) families, float32 on the CPU: the checks and bounds
of ``test_torch_train_step.py`` (which holds the dense, moe and vlm
families), one JAX compile per configuration."""
import pytest

from test_torch_train_step import (build_family,
                                   check_hidden_states_and_aux,
                                   check_loss_and_gradients)
from torch_threads import one_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", params=["recurrentgemma-2b", "mamba2-2.7b",
                                        "whisper-large-v3"])
def family(request):
    return build_family(request.param)


def test_hidden_states_and_aux(family):
    check_hidden_states_and_aux(family)


def test_loss_and_gradients(family):
    check_loss_and_gradients(family)
