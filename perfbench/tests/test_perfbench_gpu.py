"""The harness on the card at a size the tests hold: a traced run of each
tiny cell reads the device's busy time, the per-layer metrics (the
shares of the peaks at most 100 %) and the card's power. Marked ``gpu``;
it decides inside a fixture whether there is a card, and skips without
one."""
import pytest

from perfbench import harness
from perfbench.tests.conftest import TINY


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(TINY))
def test_a_traced_run_on_the_card(card, tiny_root, name):
    res = harness.run(f"{name}.chat-backlog", 11, 3.0, True, root=tiny_root, device="cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert {"decode_row_occupancy", "decode_step_ms", "decode_mfu",
            "decode_hbm_share"} <= set(res["metrics"])
    assert 0 < res["metrics"]["decode_mfu"]["value"] <= 100
    assert 0 < res["metrics"]["decode_hbm_share"]["value"] <= 100


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(TINY))
def test_an_untraced_run_reads_the_cards_power(card, tiny_root, name):
    res = harness.run(f"{name}.docqa-poisson", 12, 3.0, False, root=tiny_root, device="cuda")
    assert res["correct"], res["checks"]
    assert res["metrics"]["j_per_token.open_loop"]["value"] > 0
