"""The port's fleet on the CPU: the fleet sampler, the perturbed profiles,
the firmware-ladder bans and the twins against the JAX package's; the
fleet engine path (cold wave, then a warm-started wave built from it)
against the JAX package's compiled engine; ``run_fleet`` against the JAX
package's at 64 twins and against ``BENCH_fleet.json`` at 1024; and the
port's counterparts of ``tests/test_fleet.py``.

Tolerances. Perturbations, profiles, bans, landscapes, targets and noise
seeds (plain numpy copies): bitwise. Row traces, prohibited masks, window
rows and anchors of the engine: exact (the decisions are float32
comparisons on the same float32 products; the port's dCor gathers the
window where the reference keeps incremental sums, and no decision
differs). Results blocks: ``json.dumps(..., sort_keys=True)`` equality.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core.episode import run_fleet_requests as ref_run_fleet_requests
from repro.device import hw as ref_hw
from repro.experiments import fleet as ref_fleet
from repro_torch.core.episode import run_fleet_requests
from repro_torch.device import hw
from repro_torch.experiments import fleet

ROOT = Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "BENCH_fleet.json").read_text())
# the reference tests' fleet shape (tests/test_fleet.py)
ITERS, WINDOW = 12, 6
N_WAVE = 24


def _dumps(block):
    return json.dumps(block, sort_keys=True)


# ---------------------------------------------------------------- sampling


def test_sample_perturbations_equal_reference_field_for_field():
    ours, ref = hw.sample_perturbations(64, seed=0), ref_hw.sample_perturbations(64, seed=0)
    assert len(ours) == len(ref) == 64
    for a, b in zip(ours, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert {p.ladder_variant for p in ours} == {0, 1, 2}
    assert {p.family for p in ours} == set(hw.FLEET_FAMILIES)


def test_sample_perturbations_prefix_stable():
    """Twin i's draw depends only on (seed, i): a small fleet is an exact
    prefix of a larger one."""
    small = hw.sample_perturbations(6, seed=9)
    assert small == hw.sample_perturbations(24, seed=9)[:6]
    assert hw.sample_perturbations(6, seed=10) != small
    assert hw.sample_perturbations(64, seed=0) == hw.sample_perturbations(1024, seed=0)[:64]


def test_constant_derate_rides_the_drift_schedule():
    pert = hw.sample_perturbations(1, seed=0)[0]
    sched = hw.DriftSchedule((pert.ambient(),))
    ref_sched = ref_hw.DriftSchedule((ref_hw.sample_perturbations(1, seed=0)[0].ambient(),))
    for t in (0, 5, 100):
        assert dataclasses.asdict(sched.state_at(t)) == dataclasses.asdict(
            ref_sched.state_at(t))
    assert sched.state_at(7).clock_derate == pert.ambient_derate
    assert (sched.shift_start, sched.shift_end) == (0, 0)


@pytest.mark.parametrize("i", range(6))
def test_perturbed_profile_equals_reference(i):
    ours = hw.perturbed_profile(hw.sample_perturbations(6, seed=3)[i])
    ref = ref_hw.perturbed_profile(ref_hw.sample_perturbations(6, seed=3)[i])
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.name.endswith(f"#{i:05d}")


@pytest.mark.parametrize("family", hw.FLEET_FAMILIES)
@pytest.mark.parametrize("variant", (0, 1, 2))
def test_ladder_banned_rows_equal_reference(family, variant):
    space = hw.get_profile(family).space()
    got = fleet.ladder_banned_rows(space, variant)
    want = ref_fleet.ladder_banned_rows(ref_hw.get_profile(family).space(), variant)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.any() == (variant != 0) and not got.all()


@pytest.mark.parametrize("i", range(9))
def test_build_twin_equals_reference(i):
    """Landscapes bitwise (the drift simulator's float64 math under a
    one-event ConstantDerate schedule), targets, bans and noise seeds
    equal, over the three families and the three ladder variants."""
    ours = fleet.build_twin(hw.sample_perturbations(9, seed=0)[i])
    ref = ref_fleet.build_twin(ref_hw.sample_perturbations(9, seed=0)[i])
    assert np.array_equal(ours.land_tau, ref.land_tau)
    assert np.array_equal(ours.land_p, ref.land_p)
    assert ours.land_tau.dtype == np.float64
    assert np.array_equal(ours.banned, ref.banned)
    assert dataclasses.asdict(ours.targets) == dataclasses.asdict(ref.targets)
    assert (ours.noise, ours.noise_seed) == (ref.noise, ref.noise_seed)
    assert ours.space.names == ref.space.names


def test_build_fleet_keeps_the_order():
    twins = fleet.build_fleet(12, seed=0)
    assert [t.twin_id for t in twins] == list(range(12))
    for t in twins:
        assert np.array_equal(t.land_tau, fleet.build_twin(t.pert).land_tau)


# ------------------------------------------------------ the engine's waves


@pytest.fixture(scope="module")
def waves():
    """A 24-twin cold wave in both packages, then a warm wave built in
    each package from its own cold results (every 4th twin from its
    nearest converged neighbour)."""
    ours = fleet.build_fleet(N_WAVE, seed=0)
    ref = ref_fleet.build_fleet(N_WAVE, seed=0)
    cold = run_fleet_requests([fleet._request(t) for t in ours], ITERS, WINDOW, device="cpu")
    ref_cold = ref_run_fleet_requests([ref_fleet._request(t) for t in ref], ITERS, WINDOW)

    def warm_wave(mod, twins, res):
        m2f = [mod.measurements_to_feasible(t, r["idx"]) for t, r in zip(twins, res)]
        sources = [(twins[i], res[i]) for i in range(N_WAVE) if i % 4 and m2f[i] is not None]
        ctx = []
        for i in range(0, N_WAVE, 4):
            src, src_res = mod.match_neighbor(twins[i], sources)
            ctx.append(mod.warm_context(src, src_res, twins[i]))
        return [mod._request(twins[i], warm=c) for i, c in zip(range(0, N_WAVE, 4), ctx)]

    warm_reqs = warm_wave(fleet, ours, cold)
    ref_warm_reqs = warm_wave(ref_fleet, ref, ref_cold)
    warm = run_fleet_requests(warm_reqs, ITERS, WINDOW, device="cpu")
    ref_warm = ref_run_fleet_requests(ref_warm_reqs, ITERS, WINDOW)
    return {"cold": (cold, ref_cold), "warm": (warm, ref_warm),
            "ctx": ([r["warm"] for r in warm_reqs], [r["warm"] for r in ref_warm_reqs])}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    return type(a) is type(b) and (a == b or (a != a and b != b))


@pytest.mark.parametrize("wave", ("cold", "warm"))
def test_fleet_wave_equals_reference_engine(waves, wave):
    """Row traces, prohibited masks, window rows, n_obs and anchors equal
    the JAX engine's, episode for episode."""
    ours, ref = waves[wave]
    assert len(ours) == len(ref) == (N_WAVE if wave == "cold" else N_WAVE // 4)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert set(a) == set(b)
        apart = [k for k in a if not _same(a[k], b[k])]
        assert apart == [], (wave, i, apart)
        assert a["idx"].dtype == np.int64 and a["window"].dtype == np.float32


def test_warm_contexts_equal_reference(waves):
    ours, ref = waves["ctx"]
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in a:
            assert _same(a[k], b[k]), k


def test_warm_wave_starts_from_the_inherited_context(waves):
    """A warm twin's carry holds the neighbour's window: its n_obs counts
    the inherited rows beside its own measurements."""
    (warm, _), (ctx, _) = waves["warm"], waves["ctx"]
    for res, c in zip(warm, ctx):
        assert res["n_obs"] == ITERS + c["hist"].shape[0]
        assert res["window"].shape == (WINDOW, 5 + 4)
        assert c["hist"].shape[0] == WINDOW


# --------------------------------------------------------------- the runs


@pytest.fixture(scope="module")
def fleet64():
    return fleet.run_fleet(64, seed=0, device="cpu"), ref_fleet.run_fleet(64, seed=0)


def test_run_fleet_64_equals_reference(fleet64):
    ours, ref = fleet64
    assert _dumps(ours["results"]) == _dumps(ref["results"])
    assert ours["results"]["warm_matched"] == 16


def test_run_fleet_engine_block(fleet64):
    """The engine block keeps the reference's keys; on the CPU it names
    the backend and measures no device memory."""
    ours, ref = fleet64
    eng = ours["engine"]
    assert set(eng) == set(ref["engine"])
    assert eng["backend"] == "cpu" and eng["peak_device_bytes"] is None
    assert eng["table_bytes"] == ref["engine"]["table_bytes"]
    assert eng["consts_bytes"] == ref["engine"]["consts_bytes"]
    assert eng["steady_wall_s"] is None and eng["twins_per_s"] is None


def test_run_fleet_1024_reproduces_the_record():
    """The committed BENCH_fleet.json results block, key for key:
    feasible rate 0.999023, warm gain 3.385092 over 256 matched pairs,
    per-family values and convergence curves."""
    rec = fleet.run_fleet(1024, seed=0, iters=30, window=12, device="cpu")
    got, want = rec["results"], RECORD["results"]
    apart = [k for k in want if _dumps(got.get(k)) != _dumps(want[k])]
    assert apart == []
    assert _dumps(got) == _dumps(want)
    assert rec["engine"]["consts_bytes"] == RECORD["engine"]["consts_bytes"]


def test_fleet_results_deterministic():
    a = fleet.run_fleet(n_twins=8, seed=3, iters=ITERS, window=WINDOW, device="cpu")
    b = fleet.run_fleet(n_twins=8, seed=3, iters=ITERS, window=WINDOW, device="cpu")
    assert _dumps(a["results"]) == _dumps(b["results"])


def test_fleet_warm_start_beats_cold():
    rec = fleet.run_fleet(n_twins=12, seed=0, iters=ITERS, window=WINDOW, device="cpu")
    res = rec["results"]
    assert res["feasible_rate"] > 0.5
    assert res["warm_matched"] >= 1
    assert res["warm_gain"] is not None and res["warm_gain"] > 1.0
    for curves in res["convergence"].values():
        assert len(curves["cold"]) == ITERS
        assert all(x <= y for x, y in zip(curves["cold"], curves["cold"][1:]))
    assert rec["engine"]["table_bytes"] > 0 and rec["engine"]["batch_bytes"] > 0


def test_fleet_banned_rows_never_chosen():
    """Firmware-locked rows are born prohibited: no twin with a ladder
    variant ever measures a banned configuration, and its final
    prohibited mask holds every banned row."""
    twins = [fleet.build_twin(p) for p in hw.sample_perturbations(9, seed=1)
             if p.ladder_variant != 0]
    assert twins, "sampler produced no ladder variants in 9 draws"
    results = run_fleet_requests([fleet._request(t) for t in twins], ITERS, WINDOW,
                                 device="cpu")
    for twin, res in zip(twins, results):
        assert not np.isin(res["idx"], np.flatnonzero(twin.banned)).any()
        assert res["prohibited"][twin.banned].all()


def test_fleet_window_must_not_exceed_iters():
    twin = fleet.build_twin(hw.sample_perturbations(1, seed=0)[0])
    with pytest.raises(ValueError, match="window"):
        run_fleet_requests([fleet._request(twin)], iters=4, window=6, device="cpu")
    assert run_fleet_requests([], device="cpu") == []
