"""Fixtures of the benchmark's CPU tests: the repository's root and ``src``
on the path, and a copy of the benchmark with cells of its own at a size
the CPU holds (``tiny_root``), added as files."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

TINY = {
    "tiny-qwen2": ("qwen2.5-3b", dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                                      num_key_value_heads=2, head_dim=16, intermediate_size=128,
                                      vocab_size=256)),
    "tiny-mamba2": ("mamba2-2.7b", dict(num_hidden_layers=2, hidden_size=64, head_dim=16,
                                        num_heads=8, state_size=16, chunk_size=8,
                                        vocab_size=256)),
}
# the tiny cells' limit on the widest logit gap: sound CPU runs read 0 to
# 0.036 over eight seeds, the fp8 control 0.30 and 0.41 at most over the
# four seeds of its test
TINY_LIMIT = 0.1


def add_tiny_cells(root: Path) -> list:
    """Add two tiny configurations, two tiny traffic mixes and their four
    cells to the benchmark copy under ``root``, as new files and new
    entries of its ``BENCHMARK.json`` (the backlog cells report the
    backlog metrics; the open-loop ones metrics of their own); the cells'
    names."""
    pb = root / "perfbench"
    for name, (base, sizes) in TINY.items():
        conf = json.loads((pb / "configs" / f"{base}.json").read_text())
        conf.update(name=name, **sizes)
        (pb / "configs" / f"{name}.json").write_text(json.dumps(conf))
    for mix, lens, out in (("chat-backlog", [8, 16], [4, 8]), ("docqa-poisson", [16, 32], [2, 6])):
        d = json.loads((pb / "traffic" / f"{mix}.json").read_text())
        d.update(prompt_lens=lens, new_tokens=out)
        (pb / "traffic" / f"tiny-{mix}.json").write_text(json.dumps(d))
    man = json.loads((root / "BENCHMARK.json").read_text())
    names = []
    for cfg in TINY:
        for mix in ("chat-backlog", "docqa-poisson"):
            name = f"{cfg}.{mix}"
            names.append(name)
            man["workloads"].append({"name": name, "config": cfg, "traffic": f"tiny-{mix}",
                                     "chips": 1, "why": "CPU test"})
            # the trace opens at the window's first call: on the card the
            # tiny backlog is served within half a second
            spec = {"batch": 4, "concurrency": 2, "latency_over": "window", "grace_s": 0,
                    "trace_after_s": 0.0, "trace_s": 1.0,
                    "sample_tokens": 40, "sample_requests": 4,
                    "limits": {"widest_logit_gap": TINY_LIMIT}}
            if mix == "chat-backlog":
                spec.update(max_len=25, traffic={"requests": 16, "group": 4})
            else:
                spec.update(max_len=40, traffic={"rate": 4.0}, latency_over="due", grace_s=30)
            (pb / "workloads" / f"{name}.json").write_text(json.dumps(spec))
            if mix == "chat-backlog":
                for m in man["end_to_end"] + man["per_layer"]:
                    if "workloads" in m:
                        m["workloads"].append(name)
    # the open-loop cells' end-to-end metrics, as new entries
    docqa = [n for n in names if n.endswith("docqa-poisson")]
    man["end_to_end"] += [
        {"name": "ttft_p90_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": docqa},
        {"name": "output_tok_s.open_loop", "unit": "tokens/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": docqa},
        {"name": "j_per_token.open_loop", "unit": "J/token", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": docqa}]
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return names


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads for the benchmark's tests, restored after: the
    suite runs beside other workers on the same cores."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and ``perfbench/``)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


@pytest.fixture
def tiny_root(bench_copy) -> Path:
    add_tiny_cells(bench_copy)
    return bench_copy
