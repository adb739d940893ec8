"""The plain references against the program at a size the CPU holds: the
same weights (``weights.draw``) through the program's engine, in float32
compute, and through the reference. The prefill's last logits agree to
float32 rounding; the decode steps' read the program's bfloat16 cache
(K/V, or the SSM state), so they agree to that cache's rounding."""
import json

import numpy as np
import pytest
import torch

from perfbench import manifest, program, weights
from perfbench.tests.conftest import TINY

# float32 on both sides: orders of float32 rounding
PREFILL_TOL = 1e-5
# the program's cache holds bfloat16 (2^-8 relative) whatever the compute dtype
DECODE_TOL = 5e-3


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_against_the_program(tiny_root, name):
    conf = json.loads((tiny_root / "perfbench" / "configs" / f"{name}.json").read_text())
    conf["dtype"] = "float32"
    params = weights.draw(conf, program.param_shapes(program.model_config(conf)), 7, "cpu")
    b, s, steps = 2, 12, 5
    engine = program.build_engine(conf, params, b, s + steps + 1, "cpu")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, conf["vocab_size"], (b, s), dtype=np.int32)
    feed = rng.integers(0, conf["vocab_size"], (b, steps), dtype=np.int32)
    k = engine.acquire()
    cache, lg = engine.prefill(prompt, entry=k)
    got = [lg[:, -1].float()]
    for j in range(steps):
        cache, lg = engine.decode(cache, feed[:, j:j + 1])
        got.append(lg[:, -1].float())
    got = torch.stack(got, dim=1)  # (b, steps + 1, vocab)
    ref = manifest.reference(conf["family"], tiny_root)
    for row in range(b):
        seq = torch.as_tensor(np.concatenate([prompt[row], feed[row]]))
        want = ref.logits(conf, params, seq, s - 1)
        scale = want.abs().max()
        assert (got[row, 0] - want[0]).abs().max() <= PREFILL_TOL * scale
        assert (got[row, 1:] - want[1:]).abs().max() <= DECODE_TOL * scale


@pytest.mark.parametrize("name", sorted(TINY))
def test_fp8_control_is_not_the_reference(tiny_root, name):
    conf = json.loads((tiny_root / "perfbench" / "configs" / f"{name}.json").read_text())
    params = weights.draw(conf, program.param_shapes(program.model_config(conf)), 8, "cpu")
    ref = manifest.reference(conf["family"], tiny_root)
    seq = torch.as_tensor(np.random.default_rng(1).integers(0, conf["vocab_size"], 20))
    full = ref.logits(conf, params, seq, 10)
    low = ref.logits(conf, params, seq, 10, precision="fp8")
    err = (full - low).abs().max() / full.abs().max()
    assert 1e-3 < err < 0.5
