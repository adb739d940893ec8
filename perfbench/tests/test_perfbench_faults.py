"""A run of the harness with the timed path broken underneath comes out
not correct, and a sound one correct: on the CPU, at a size it holds,
every step of a run but the look for a chip (``harness.run`` with
``device="cpu"``). The faults a served cell can have: a decode step that
leaves its state as it was; half of the batch left out, its rows given
the mean of the rest; a token altered where it is produced. (One chip:
no exchange between chips to leave out.)"""
import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import TINY

# long enough for the tiny backlog's requests to finish on a busy host
WINDOW_S = 3.0


class _Host:
    """Host logits with ``fix`` applied to them when they are read."""

    def __init__(self, inner, fix):
        self.inner, self.fix = inner, fix

    def wait(self):
        return self.fix(np.array(self.inner.wait()))


def state_unchanged(engine, rt):
    orig = engine.decode

    def decode(cache, tokens):
        saved = {p: {k: t.clone() for k, t in c.items()} for p, c in cache.items()
                 if isinstance(c, dict)}
        length = cache["length"].clone()
        out = orig(cache, tokens)
        with torch.inference_mode():
            for p, c in saved.items():
                for k, t in c.items():
                    cache[p][k].copy_(t)
            cache["length"].copy_(length)
        return out

    engine.decode = decode


def _fix_logits(engine, fix):
    orig = engine.fetch_last
    engine.fetch_last = lambda logits: _Host(orig(logits), fix)


def half_batch_left_out(engine, rt):
    def fix(lg):
        half = lg.shape[0] // 2
        lg[half:] = lg[:half].mean(axis=0)
        return lg

    _fix_logits(engine, fix)


def token_altered(engine, rt):
    def fix(lg):
        rows = np.arange(lg.shape[0])
        lg[rows, lg.argmax(axis=-1)] = lg.min()  # the best token can no longer win
        return lg

    _fix_logits(engine, fix)


def _run(root, cell, fault=None):
    return harness.run(cell, 2**31 + 5, WINDOW_S, False, root=root, device="cpu", fault=fault)


@pytest.mark.parametrize("mix", ["chat-backlog", "docqa-poisson"])
@pytest.mark.parametrize("name", sorted(TINY))
def test_a_sound_run_is_correct(tiny_root, name, mix):
    res = _run(tiny_root, f"{name}.{mix}")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [state_unchanged, half_batch_left_out, token_altered])
@pytest.mark.parametrize("name", sorted(TINY))
def test_a_broken_timed_path_is_not_correct(tiny_root, name, fault):
    res = _run(tiny_root, f"{name}.chat-backlog", fault)
    assert not res["correct"], res["checks"]
    assert res["checks"]["widest_logit_gap"]["value"] > res["checks"]["widest_logit_gap"]["limit"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_fp8_control_is_not_correct(tiny_root, name):
    """The control (``control.py``): the reference in fp8 put in the
    program's place, judged on the same sampled requests as the program,
    over four seeds (a tiny model's few dozen tokens per run hold few
    near-ties for fp8 to flip)."""
    from perfbench import check

    prog, ctrl = [], []
    for seed in (2**31 + 5, 3, 4, 5):
        res = harness.run(f"{name}.chat-backlog", seed, WINDOW_S, False, root=tiny_root,
                          device="cpu", keep=True)
        kept = res.pop("_kept")
        assert res["correct"]
        prog += kept["gaps"]
        ctrl += [check.gaps(kept["ref"].logits, kept["conf"], kept["params"], r, "cpu",
                            precision="fp8") for r in kept["picked"]]
    limit = res["checks"]["widest_logit_gap"]["limit"]
    assert np.concatenate(ctrl).max() > limit > np.concatenate(prog).max()
