"""The published Hymba (family ``hymba``) at a size the CPU holds: the
program (``use_kernels=False``) against the plain reference
(``perfbench/reference/hymba.py``), a whole tiny cell through
``harness.run``, and the family's counts against hand-worked values.

The tiny model keeps the published shapes at small widths: d 64, 6
layers, 4 query heads over 2 K/V heads of 16 (V 32, so that the attention
output is d_inner = 128), a window of 8, 4 meta tokens, global layers 0
and 5 from the configuration's list, layers 1-3 one K/V group (a triple)
and layer 4 a cache of its own: 4 K/V caches for 6 layers.

Tolerances, float32 compute on both sides. The prefill's logits and a
decode step's from a float32 cache: 1e-4 (orders of float32 rounding;
sound runs read ~1e-6 on logits of ~4). From the program's bf16 caches
(K/V, SSM and conv states, as served): 5e-2, since every cached element is
rounded to bf16 (2^-9 of it) and the decode steps read them back; sound
runs read 1.1e-2 to 2.1e-2 over eight steps. Hiding the meta tokens
behind the window moves the logits by more than 0.5 (the sink's test).
"""
import json

import numpy as np
import pytest
import torch

from perfbench import harness, instrument, manifest, program, weights
from perfbench.counts import flash_window, selective_scan
from perfbench.families import hymba as family
from perfbench.tests.conftest import ROOT
from perfbench.tests.test_perfbench_families import _HostEvent

PREFILL_TOL = 1e-4
DECODE_F32_TOL = 1e-4
DECODE_BF16_TOL = 5e-2
TINY_SIZES = dict(num_hidden_layers=6, hidden_size=64, intermediate_size=128,
                  num_attention_heads=4, num_key_value_heads=2, v_head_dim=32, vocab_size=256,
                  num_memory_tokens=4, sliding_window=8, global_attn_idx=[0, 5],
                  kv_reuse_group=[[1, 2, 3]], mamba_dt_rank=4)
CELL = "tiny-hymba.docqa-poisson"
# the Hymba cell's per-layer metrics: those read from the profiler's
# record of the card, and those a CPU run reads too, each with its range
# (a retire that begins inside the window counts whole, so the host's busy
# share may pass 1 where the host does the device's work)
DEVICE_TRACE = ("prefill_mfu", "selective_scan_roofline_share", "flash_prefill_roofline_share",
                "device_idle_share.tok_s")
READ_ON_THE_CPU = {"decode_row_occupancy": (0, 1), "decode_row_occupancy.program": (0, 1),
                   "decode_step_ms": (0, float("inf")), "decode_mfu": (0, 100),
                   "decode_hbm_share": (0, 100), "retire_host_ms": (0, float("inf")),
                   "host_busy_share": (0, float("inf"))}
# the tiny cell's limit on the widest logit gap, as the other tiny cells'
# (conftest.TINY_LIMIT): sound CPU runs read 0
TINY_LIMIT = 0.1


def _conf(**sizes):
    conf = json.loads((ROOT / "perfbench" / "configs" / "hymba-1.5b.json").read_text())
    conf.update(name="tiny-hymba", **TINY_SIZES)
    conf.update(sizes)
    return conf


def _model(conf, seed=7):
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models.transformer import ApplyCtx

    cfg = program.model_config(conf)
    params = weights.draw(conf, program.param_shapes(cfg), seed, "cpu")
    rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", use_kernels=False)
    return ApplyCtx(cfg, rcfg), params


def _tokens(n_rows, n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n_rows, n), dtype=np.int32))


def _reference(conf, params, toks):
    ref = manifest.reference("hymba")
    return torch.stack([ref.logits(conf, params, row, 0) for row in toks])


def test_the_tiny_model_has_the_published_layout():
    ctx, params = _model(_conf())
    cfg = ctx.cfg
    assert cfg.kv_slots() == (0, 1, 1, 1, 2, 3) and cfg.n_kv_caches == 4
    assert cfg.global_layers == (0, 5) and cfg.n_meta_tokens == 4 and cfg.v_head_dim == 32
    assert params["kv_proj"].shape == (4, 64, 2 * (16 + 32))
    assert params["meta_tokens"].shape == (4, 64)
    assert params["layers"]["A_log"].shape == (6, 128, 16)


@pytest.mark.parametrize("prompt", [12, 2], ids=["prompt-12", "prompt-2"])
@pytest.mark.parametrize("cache_dtype,tol", [(torch.float32, DECODE_F32_TOL),
                                             (torch.bfloat16, DECODE_BF16_TOL)],
                         ids=["float32-cache", "bf16-cache"])
def test_prefill_then_decode_against_the_references_full_forward(cache_dtype, tol, prompt):
    """Prefill 12 tokens (16 positions with the meta tokens), then decode 8
    through the cache: by the last step the window of 8 has long passed
    the meta tokens, which only its sink keeps visible. From a prompt of 2
    the first steps' windows still reach into the meta tokens, which the
    window layers' gathered keys (``hymba._window_keys``) then read once."""
    from repro_torch.models import hymba
    from repro_torch.models.transformer import decode_step, prefill

    conf = _conf()
    ctx, params = _model(conf)
    toks = _tokens(2, 20)
    want = _reference(conf, params, toks)
    assert (want.abs().max() > 1.0).item()
    assert (hymba.forward(ctx, params, toks) - want).abs().max().item() <= PREFILL_TOL
    cache = hymba.empty_cache(ctx.cfg, 2, 24, dtype=cache_dtype)
    cache, last = prefill(ctx, params, {"tokens": toks[:, :prompt]}, out=cache)
    assert int(cache["length"]) == prompt + 4
    assert (last[:, 0] - want[:, prompt - 1]).abs().max().item() <= PREFILL_TOL
    for t in range(prompt, prompt + 8):
        cache, lg = decode_step(ctx, params, cache, toks[:, t:t + 1])
        assert (lg[:, 0] - want[:, t]).abs().max().item() <= tol, t


def test_the_sink_keeps_the_meta_tokens_once_the_window_has_passed_them():
    """Past the window, a query still sees the 4 meta tokens: hiding them
    (sink 0) moves the logits far beyond any tolerance above, and only at
    positions where the window has passed them."""
    from repro_torch.models import hymba

    conf = _conf()
    ctx, params = _model(conf)
    toks = _tokens(1, 20, seed=3)
    with_sink = hymba.forward(ctx, params, toks)
    torch.testing.assert_close(with_sink, _reference(conf, params, toks), atol=PREFILL_TOL, rtol=0)
    hidden = hymba._window
    try:
        hymba._window = lambda cfg, i: (hidden(cfg, i)[0], 0)
        blind = hymba.forward(ctx, params, toks)
    finally:
        hymba._window = hidden
    gap = (blind - with_sink).abs().amax(dim=-1)[0]  # per prompt position
    # position p + 4 sees all 4 meta tokens inside a window of 8 while p <= 3
    assert gap[:4].max().item() <= PREFILL_TOL
    assert gap[8:].min().item() > 10 * DECODE_BF16_TOL


def test_the_gathered_window_keys_equal_the_whole_masked_cache(monkeypatch):
    """A window layer's decode step reads the slots of its sink and window
    only: the same logits as attending over every slot under the mask,
    also once the ring of 14 slots has wrapped and overwritten the meta
    tokens (float32 cache: only the order of float32 sums differs)."""
    from repro_torch.models import hymba
    from repro_torch.models.transformer import _ring_kv_pos, decode_step, prefill

    ctx, params = _model(_conf())
    toks = _tokens(2, 16, seed=5)

    def run():
        cache = hymba.empty_cache(ctx.cfg, 2, 14, dtype=torch.float32)
        cache, _ = prefill(ctx, params, {"tokens": toks[:, :2]}, out=cache)
        out = []
        for t in range(2, 16):  # positions 6 .. 19 over 14 slots
            cache, lg = decode_step(ctx, params, cache, toks[:, t:t + 1])
            out.append(lg)
        return torch.cat(out, dim=1)

    gathered = run()
    monkeypatch.setattr(hymba, "_window_keys", lambda t, w, window, sink, b: (
        torch.arange(w), _ring_kv_pos(t, w, t.device).expand(b, w)))
    whole = run()
    assert (gathered - whole).abs().max().item() <= DECODE_F32_TOL


def test_a_layer_that_reuses_k_v_writes_no_cache(monkeypatch):
    """Prefill and a decode step write K/V for the first layer of each group
    only, into the group's one entry; the others read it."""
    from repro_torch.models import hymba
    from repro_torch.models.transformer import decode_step, prefill

    ctx, params = _model(_conf())
    cache = hymba.empty_cache(ctx.cfg, 2, 24)
    assert cache["main"]["k"].shape[0] == 4 and cache["main"]["ssm"].shape[0] == 6
    writes = []
    store = hymba._store

    def spy(c, new, slot=None):
        kind = "k" if c.shape[-1] == 16 else "v"
        entry = next(i for i in range(4) if cache["main"][kind][i].data_ptr() == c.data_ptr())
        writes.append((kind, entry))
        store(c, new, slot)

    monkeypatch.setattr(hymba, "_store", spy)
    toks = _tokens(2, 13)
    cache, _ = prefill(ctx, params, {"tokens": toks[:, :12]}, out=cache)
    assert writes == [(kind, e) for e in range(4) for kind in ("k", "v")]
    writes.clear()
    decode_step(ctx, params, cache, toks[:, 12:])
    assert writes == [(kind, e) for e in range(4) for kind in ("k", "v")]


def test_the_engine_counts_the_meta_tokens_and_the_shared_caches():
    conf = _conf()
    conf["dtype"] = "float32"
    ctx, params = _model(conf)
    engine = program.build_engine(conf, params, 2, 20, "cpu")
    assert engine.prefix_tokens == 4 and engine.kv_caches == 4
    k = engine.acquire()
    engine.prefill(_tokens(2, 16).numpy(), entry=k)  # 4 + 16 positions: fits
    with pytest.raises(ValueError, match="overflows"):
        engine.prefill(_tokens(2, 17).numpy(), entry=k)



def test_serve_sizes_its_pool_entries_for_the_meta_tokens(monkeypatch):
    """``launch/serve.py::serve`` of the published Hymba (here its tiny
    mapping in place of the registry entry): a pool entry's slots hold the
    meta tokens, the prompt and the decoded tokens, and every request is
    served in full."""
    from repro_torch.launch import serve as launcher

    cfg = program.model_config(_conf())
    monkeypatch.setattr(launcher, "get_config", lambda arch: cfg)
    m = launcher.serve("hymba-1.5b-base", requests=4, prompt_len=12, new_tokens=2, batch=2,
                       device="cpu")
    assert m["requests"] == 4 and m["queue_depth"] == 0


def _add_tiny_cell(root):
    """A tiny Hymba configuration, a tiny docqa mix and their open-loop
    cell, as new files and new entries of the copy's ``BENCHMARK.json``,
    the cell appended to the lists of the metrics the Hymba cell reports."""
    pb = root / "perfbench"
    (pb / "configs" / "tiny-hymba.json").write_text(json.dumps(_conf()))
    mix = json.loads((pb / "traffic" / "docqa-poisson.json").read_text())
    mix.update(prompt_lens=[16, 32], new_tokens=[2, 6])
    (pb / "traffic" / "tiny-hymba-docqa.json").write_text(json.dumps(mix))
    (pb / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"batch": 4, "concurrency": 2, "max_len": 44, "traffic": {"rate": 4.0},
         "latency_over": "due", "grace_s": 30, "trace_after_s": 0.0, "trace_s": 1.0,
         "trace_on_prefill": True, "sample_tokens": 40, "sample_requests": 4,
         "limits": {"widest_logit_gap": TINY_LIMIT}}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-hymba", "source": "test",
                           "file": "perfbench/configs/tiny-hymba.json", "reduced": [],
                           "why": "CPU test"})
    man["workloads"].append({"name": CELL, "config": "tiny-hymba", "traffic": "tiny-hymba-docqa",
                             "chips": 1, "why": "CPU test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "hymba-1.5b.docqa-poisson" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(man))


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_tiny_cell_runs_whole(bench_copy, monkeypatch, trace):
    """The timed path end to end on the CPU: the meta tokens prefilled per
    row, graphless decode over the shared caches, every due request served
    and the served tokens the reference's best. Traced, the decode and
    runtime readers read the run, the decode steps timed by the host's
    clock in place of CUDA events (``_HostEvent``); with no card there is
    no device trace, so the readers of the profiler's record give nothing
    and the line leaves them out."""
    _add_tiny_cell(bench_copy)
    cell = manifest.cell(CELL, bench_copy)
    assert {m["name"] for m in cell["per_layer"]} == set(DEVICE_TRACE) | set(READ_ON_THE_CPU)
    monkeypatch.setattr(instrument.Instrument, "_events", lambda self: (_HostEvent(), _HostEvent()))
    res = harness.run(CELL, 2**31 + 35, 3.0, trace, root=bench_copy, device="cpu")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    if trace:
        assert set(res["metrics"]) == set(READ_ON_THE_CPU)
        for name, (low, high) in READ_ON_THE_CPU.items():
            assert low < res["metrics"][name]["value"] <= high, name
    else:
        assert {"output_tok_s", "tpot_p95_ms", "setup_s"} <= set(res["metrics"])


def test_groups_record_the_prefixed_positions():
    from repro_torch.serving.runtime import Request, ServingRuntime

    conf = _conf()
    conf["dtype"] = "float32"
    ctx, params = _model(conf)
    engine = program.build_engine(conf, params, 2, 24, "cpu")
    rt = ServingRuntime(engine, batch_size=2, concurrency=1)
    rt.submit(Request(0, _tokens(1, 8).numpy()[0], 3))
    rt.drain()
    (req,) = rt.done
    assert req.group.prefix_tokens == 4 and req.group.prompt_len == 8


def test_the_committed_configuration_builds_the_published_model():
    """The file's keys set on the port-only registry entry give that entry
    back field for field: the file and the program's published Hymba
    agree (and the mirrored ``hymba-1.5b`` is another model)."""
    from repro_torch.configs.registry import REGISTRY, get_config

    conf = manifest.cell("hymba-1.5b.docqa-poisson")["conf"]
    cfg = program.model_config(conf)
    assert cfg == get_config(conf["registry"])
    assert cfg.n_kv_caches == 17 and cfg.global_layers == (0, 15, 31)
    assert "hymba-1.5b-base" not in REGISTRY and cfg != REGISTRY["hymba-1.5b"]


# A tiny configuration worked by hand: L 3, d 8, 2 query heads over 1 K/V
# head of 4 (V 8, d_inner 16), N 2, dt_rank 2, ff 4, vocab 10 (tied), 2 meta
# tokens, a window of 3, layer 0 global, layers 1-2 one group; bf16 with the
# committed float32 leaves.
HAND = dict(num_hidden_layers=3, hidden_size=8, num_attention_heads=2, num_key_value_heads=1,
            v_head_dim=8, mamba_d_state=2, mamba_dt_rank=2, intermediate_size=4, vocab_size=10,
            num_memory_tokens=2, sliding_window=3, global_attn_idx=[0], kv_reuse_group=[[1, 2]])


def test_prefill_flops_by_hand():
    # 4 positions (2 meta + 2); matmul MACs a position and layer: in_proj
    # 8·40 + x_proj 16·6 + dt_proj 2·16 + out_proj 16·8 + FFN 3·8·4 = 672,
    # + kv_proj 8·12 = 96 in layers 0 and 1: (768 + 768 + 672)·2·4 = 17,664;
    # the scan 6·4·16·2 = 768 a layer, 2,304; the head 2·8·10 = 160;
    # attention 10 pairs a layer (global 1+2+3+4; window 1+2+3+(3+1 sink)),
    # 2·2·(4+8)·10 = 480 a layer, 1,440: 21,568
    c = _conf(**HAND)
    assert family.prefill_flops(c, 1, 2) == 21568.0
    assert family.prefill_flops(c, 3, 2) == 3 * 21568.0


def test_decode_flops_and_bytes_by_hand():
    # position 2 + 2 meta = 4: 5 keys in every layer (the window's 3 and
    # both meta tokens); matmuls 4,416, attention 3·2·2·12·5 = 720, the
    # scan step 3·6·32 = 576, the head 160: 5,872
    c = _conf(**HAND)
    assert family.decode_flops(c, 1, 2) == 5872.0
    # weights: a layer's leaves 1,944 B (bf16, the norms, dt_bias and A_log
    # in float32) · 3, kv_proj 2·8·12·2 = 384, final_norm 32, the tied
    # embedding 160: 6,408; a row: the 2 K/V caches once, 5 positions of 12
    # each, and 3 layers' state (32) and conv state (3·16) read and written:
    # (120 + 480)·2 = 1,200
    assert family.decode_bytes(c, 1, 2) == 6408.0 + 1200.0
    assert family.decode_bytes(c, 2, 2) == 6408.0 + 2 * 1200.0


def test_the_published_k_v_caches_are_counted_once():
    c = json.loads((ROOT / "perfbench" / "configs" / "hymba-1.5b.json").read_text())
    assert len(set(family.kv_owners(c))) == 17
    t = 100  # 228 positions with the meta tokens: inside every window
    per_row = family.decode_bytes(c, 1, t) - family.decode_bytes(c, 0, t)
    state = 2 * 32 * (3200 * 16 + 3 * 3200)
    assert per_row == 2 * (17 * (t + 128 + 1) * 5 * (64 + 128) + state)
    t = 4000  # past the window: 14 group caches hold 1,024 + 128 positions
    per_row = family.decode_bytes(c, 1, t) - family.decode_bytes(c, 0, t)
    assert per_row == 2 * ((3 * (t + 129) + 14 * 1152) * 5 * 192 + state)


@pytest.mark.parametrize("s,window,sink", [(1, 3, 2), (7, 3, 2), (40, 8, 4), (40, 8, 30),
                                           (300, 64, 16), (12, None, 0), (50, 100, 8)])
def test_window_pairs_in_closed_form(s, window, sink):
    brute = sum(1 for i in range(s) for j in range(i + 1)
                if window is None or i - j < window or j < sink)
    assert flash_window.pairs(s, window, sink) == brute
    assert sum(flash_window.visible(i, window, sink) for i in range(s)) == brute


def test_selective_scan_counts_by_hand():
    # B 2, S 3, di 4, N 2: 6·48 = 288 FLOP; x, dt, z, y 4·24·2 = 192 B, B and
    # C 2·12·2 = 48, A_log 8·4 + dt_bias and D 2·4·4 = 64, the state 16·2 = 32
    assert selective_scan.flops(2, 3, 4, 2) == 288.0
    assert selective_scan.nbytes(2, 3, 4, 2) == 192.0 + 48.0 + 64.0 + 32.0


def test_every_cell_flash_launch_is_bound_by_operations():
    """``flash_prefill_roofline_share`` hands ``roofline_share`` the layers'
    mean (FLOPs, bytes): exact only while every launch is bound by its
    operations, which holds at each prompt length of the cell."""
    from perfbench.counts import peaks

    for s in (2048, 4096, 7936):
        t = s + 128
        by_bytes = flash_window.nbytes(8, 25, 5, t, 64, 128) / peaks.HBM_BYTES
        for window, sink in ((1024, 128), (None, 0)):
            assert flash_window.flops(8, 25, t, 64, 128, window, sink) / peaks.BF16_FLOPS > by_bytes
