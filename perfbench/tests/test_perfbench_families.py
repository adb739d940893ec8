"""Model families as files (``perfbench/families/<family>.py``, found by
``manifest.family``): a family added by files alone runs a whole cell,
correct, with the model step's shares of the peaks read, and no file of
the benchmark edited; a configuration of a family with no file raises and
names the file; and the committed configurations build the program's
``ModelConfig`` field for field as the mapping kept in ``program.py``
before the families had files of their own did."""
import dataclasses
import json
import shutil
import time

import pytest

from perfbench import harness, instrument, manifest, program
from perfbench.counts import model
from perfbench.tests.conftest import ROOT, TINY, TINY_LIMIT

WINDOW_S = 3.0
CELL = "tiny-tinyfam.chat-backlog"


class _HostEvent:
    """Stands in for a CUDA event on the CPU, where there is none: the
    host's clock at ``record``, so that the readers that divide by a
    decode's device time find a time to divide by."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def add_tinyfam(root):
    """A family ``tinyfam`` (the Qwen2 family's file and reference under a
    new name), a tiny configuration of it, a tiny backlog mix and its cell,
    as new files and new entries of ``BENCHMARK.json``."""
    pb = root / "perfbench"
    shutil.copy(pb / "families" / "qwen2.py", pb / "families" / "tinyfam.py")
    shutil.copy(pb / "reference" / "qwen2.py", pb / "reference" / "tinyfam.py")
    base, sizes = TINY["tiny-qwen2"]
    conf = json.loads((pb / "configs" / f"{base}.json").read_text())
    conf.update(name="tiny-tinyfam", family="tinyfam", **sizes)
    (pb / "configs" / "tiny-tinyfam.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "chat-backlog.json").read_text())
    mix.update(prompt_lens=[8, 16], new_tokens=[4, 8])
    (pb / "traffic" / "tiny-tinyfam-backlog.json").write_text(json.dumps(mix))
    (pb / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"batch": 4, "concurrency": 2, "max_len": 25, "traffic": {"requests": 16, "group": 4},
         "latency_over": "window", "grace_s": 0, "trace_after_s": 0.0, "trace_s": 1.0,
         "sample_tokens": 40, "sample_requests": 4, "limits": {"widest_logit_gap": TINY_LIMIT}}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-tinyfam", "source": "test", "file":
                           "perfbench/configs/tiny-tinyfam.json", "reduced": [], "why": "test"})
    man["workloads"].append({"name": CELL, "config": "tiny-tinyfam",
                             "traffic": "tiny-tinyfam-backlog", "chips": 1, "why": "CPU test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(man))


def test_a_family_added_by_files_alone_runs_a_whole_cell(bench_copy, monkeypatch):
    pb = bench_copy / "perfbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    add_tinyfam(bench_copy)
    monkeypatch.setattr(instrument.Instrument, "_events", lambda self: (_HostEvent(), _HostEvent()))
    res = harness.run(CELL, 2**31 + 9, WINDOW_S, True, root=bench_copy, device="cpu")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert {"decode_mfu", "decode_hbm_share"} <= set(res["metrics"])
    assert all(res["metrics"][m]["value"] > 0 for m in ("decode_mfu", "decode_hbm_share"))
    fam = manifest.family("tinyfam", bench_copy)
    assert fam.__file__ == str(pb / "families" / "tinyfam.py")
    after = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file() and p in before}
    assert after == before


@pytest.mark.parametrize("count", [
    lambda c: program.model_config(c),
    lambda c: model.prefill_flops(c, 1, 8),
    lambda c: model.decode_flops(c, 1, 8),
    lambda c: model.decode_bytes(c, 1, 8),
], ids=["model_config", "prefill_flops", "decode_flops", "decode_bytes"])
def test_an_unknown_family_raises_and_names_its_file(count):
    conf = json.loads((ROOT / "perfbench" / "configs" / "qwen2.5-3b.json").read_text())
    conf["family"] = "no-such-family"
    with pytest.raises(FileNotFoundError, match="perfbench/families/no-such-family.py"):
        count(conf)


# The mapping as ``program.py`` held it before each family had a file of
# its own: the witness that moving it changed nothing.
_PARENT_QWEN2_KEYS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model", "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim", "intermediate_size": "d_ff",
    "vocab_size": "vocab", "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings", "attention_bias": "qkv_bias"}
_PARENT_MAMBA2_KEYS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model", "vocab_size": "vocab",
    "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings"}
_PARENT_MAMBA2_SSM_KEYS = {
    "state_size": "d_state", "head_dim": "headdim", "expand": "expand",
    "chunk_size": "chunk_size", "conv_kernel": "d_conv"}


def _parent_model_config(conf):
    from repro_torch.configs.registry import get_config

    base = get_config(conf["registry"])
    if conf["family"] == "qwen2":
        return dataclasses.replace(base, **{f: conf[k] for k, f in _PARENT_QWEN2_KEYS.items()})
    ssm = dataclasses.replace(base.ssm, **{f: conf[k] for k, f in _PARENT_MAMBA2_SSM_KEYS.items()})
    return dataclasses.replace(base, ssm=ssm,
                               **{f: conf[k] for k, f in _PARENT_MAMBA2_KEYS.items()})


@pytest.mark.parametrize("name,from_the_file", [
    ("qwen2.5-3b", {"head_dim": 128, "norm_eps": 1e-6, "tie_embeddings": True}),
    ("mamba2-2.7b", {"vocab": 50288, "tie_embeddings": True}),
])
def test_the_committed_configurations_build_the_parents_model_config(name, from_the_file):
    from repro_torch.configs.registry import get_config

    conf = manifest.cell(f"{name}.chat-backlog")["conf"]
    cfg = program.model_config(conf)
    assert cfg == _parent_model_config(conf)  # the dataclass's eq: field for field
    # what the file sets that the registry's entry holds otherwise
    assert cfg == dataclasses.replace(get_config(conf["registry"]), **from_the_file)
