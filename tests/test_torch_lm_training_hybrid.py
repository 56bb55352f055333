"""LM training of the LLM zoo against the JAX package on the CPU, the
other five archs: Jamba (Mamba + attention + MoE), the two conditioned
archs (Llama-3.2-Vision's gated cross-attention, MusicGen's codebooks
and conditioning sublayer) and two dense ones. The cases, inputs and
tolerances are ``test_torch_lm_training.py``'s; the split keeps
DeepSeek-V3 and Jamba, the slowest to trace, in different test
processes.
"""
import pytest
import torch

from test_torch_lm_training import check_forward, check_grads

ARCHS = ("jamba-v0.1-52b", "nemotron-4-15b", "qwen1.5-32b",
         "llama-3.2-vision-11b", "musicgen-large")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while the module runs (six test processes
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch):
    check_grads(arch)
