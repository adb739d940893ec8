"""``BENCHMARK.json`` against the contract's shape, and the harness finding
every piece by name, a new cell's included, from files alone."""
import json
import re
from pathlib import Path

import pytest

from perfbench import manifest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_metric_units_and_sources():
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in MAN["per_layer"])


def test_moves_names_an_end_to_end_metric_of_each_listed_cell():
    for m in MAN["per_layer"]:
        e2e = next(e for e in MAN["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in e2e.get("workloads", [w]), (m["name"], w)


def test_cells_and_configs():
    configs = {c["name"]: c for c in MAN["configs"]}
    used = {w["config"] for w in MAN["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in MAN["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in MAN["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("perfbench/") and conf["name"] == c["name"]
        assert c["reduced"] == conf["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf
            assert not key.endswith(("_dim", "_rank", "_size")) or key == "vocab_size"


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    c = manifest.cell(cell)
    manifest.generator(c["mix"]["generator"])
    manifest.reference(c["conf"]["family"])
    assert manifest.family_of(c["conf"]) is manifest.family(c["conf"]["family"], manifest.ROOT)
    for m in c["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)
    assert {"batch", "concurrency", "max_len", "latency_over", "limits"} <= set(c["spec"])


def test_a_new_cell_configuration_mix_and_metric_are_files(bench_copy):
    """Adding a cell adds files (and entries of BENCHMARK.json) and edits
    no file of the benchmark."""
    pb = bench_copy / "perfbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    conf = json.loads((pb / "configs" / "qwen2.5-3b.json").read_text())
    conf["name"] = "qwen2.5-3b-copy"
    (pb / "configs" / "qwen2.5-3b-copy.json").write_text(json.dumps(conf))
    (pb / "traffic" / "chat-burst.json").write_text(json.dumps(
        {"generator": "mmpp", "burst_factor": 4.0, "phase_s": 0.5, "traffic_seed": 1,
         "prompt_lens": [128], "new_tokens": [16, 64]}))
    (pb / "workloads" / "qwen2.5-3b-copy.chat-burst.json").write_text(json.dumps(
        {"batch": 8, "concurrency": 2, "max_len": 200, "traffic": {"rate": 2.0},
         "latency_over": "due", "limits": {"widest_logit_gap": 1.0}}))
    (pb / "metrics" / "requests_served.py").write_text(
        "def read(obs):\n    return float(len(obs.requests))\n")
    man = json.loads((bench_copy / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "qwen2.5-3b-copy.chat-burst", "config": "qwen2.5-3b-copy",
                             "traffic": "chat-burst", "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "requests_served", "unit": "requests", "better": "higher",
                             "source": "program_counter", "layer": "runtime",
                             "moves": "setup_s", "workloads": ["qwen2.5-3b-copy.chat-burst"]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(man))
    c = manifest.cell("qwen2.5-3b-copy.chat-burst", bench_copy)
    assert c["conf"]["name"] == "qwen2.5-3b-copy" and c["mix"]["burst_factor"] == 4.0
    assert [m["name"] for m in c["per_layer"]] == ["requests_served"]

    class Obs:
        requests = [1, 2, 3]

    assert manifest.reader("requests_served", bench_copy).read(Obs) == 3.0
    after = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file() and p in before}
    assert after == before
