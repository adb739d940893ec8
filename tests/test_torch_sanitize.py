"""The port's sanitizer lanes (``repro_torch.core.sanitize``), case for
case with ``tests/test_sanitize.py``: the NaN lane catches poisoned values
end to end and names the field and the step, the ``REPRO_CHECKIFY`` flag
is read at call time, the lane gives the JAX package's verdict per cell
family (a fault cell raises in both packages, as its dropped telemetry is
NaN by design; static, drift, offload, cotenant and fleet episodes run
clean in both), lane on and lane off give identical records with the same
dCor launches, and the build-count guard (the counterpart of the
reference's compile-count guard) shows that a static spec and the fleet
path build once and that the same spec with fresh data builds nothing.
"""
import json
from unittest import mock

import numpy as np
import pytest
import torch

from repro.core.episode import run_coral_batch as ref_run_coral_batch
from repro.core.evaluate import RegimeTargets as RefTargets
from repro.core.space import jetson_like_space as ref_jetson_like_space
from repro.device import jetson_like_simulator as ref_jetson_like_simulator
from repro.experiments import fleet as ref_fleet
from repro.experiments import matrix as ref_matrix
from repro.experiments import scenarios as ref_sc
from repro_torch.core import dcov as core_dcov
from repro_torch.core import episode, sanitize
from repro_torch.core.episode import run_coral_batch
from repro_torch.core.evaluate import RegimeTargets
from repro_torch.core.sanitize import NanWatch, SanitizeError
from repro_torch.core.space import jetson_like_space
from repro_torch.device import jetson_like_simulator
from repro_torch.experiments import fleet, matrix
from repro_torch.experiments import scenarios as sc
from repro_torch.kernels import runtime
from repro_torch.serving import engine as serving_engine

FAMILIES = ["static", "drift", "offload", "cotenant", "fault", "fleet"]
FLEET_KW = dict(n_twins=4, iters=10, window=6)
# the guard's fleet, cold in-process only there (as the reference's)
GUARD_FLEET_KW = dict(n_twins=4, iters=11, window=7)


@pytest.fixture(scope="module")
def cell():
    sp = jetson_like_space()
    sim = jetson_like_simulator(sp)
    lt, lp = sim.exact_all()
    tg = RegimeTargets(
        mode="dual",
        tau_target=float(np.percentile(lt, 70)),
        p_budget=float(np.percentile(lp, 60)),
    )
    return sp, np.asarray(lt), np.asarray(lp), tg


def test_checkify_lane_off_by_default(monkeypatch):
    monkeypatch.delenv("REPRO_CHECKIFY", raising=False)
    assert not sanitize.checkify_enabled()
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    assert sanitize.checkify_enabled()
    monkeypatch.setenv("REPRO_CHECKIFY", "0")
    assert not sanitize.checkify_enabled()


def test_nan_watch_catches_nan():
    watch = NanWatch()
    watch.observe(0, {"x": torch.log(torch.tensor([1.0, 2.0])), "i": torch.tensor([3])})
    watch.observe(1, {"x": torch.log(torch.tensor([-1.0, 2.0])), "i": torch.tensor([3])})
    watch.observe(2, {"x": torch.tensor([float("nan"), 0.0]), "i": torch.tensor([3])})
    assert watch.names == ["x"]  # integer values are not watched
    with pytest.raises(SanitizeError, match="nan generated .*x at step 1$"):
        watch.check()
    # clean input: check() is a no-op; an infinity is not an error
    watch = NanWatch()
    watch.observe(0, {"best_r": torch.full((3,), -float("inf")), "y": torch.zeros(2)})
    watch.check()
    NanWatch().check()  # nothing observed


def test_checkify_flag_is_read_at_call_time(monkeypatch, cell):
    """The lane is chosen when a call starts, so flipping the flag
    mid-process never leaves a call checked or unchecked by mistake: the
    same poisoned call raises with the flag on and runs with it off."""
    sp, lt, lp, tg = cell
    bad = np.full_like(lt, np.nan)
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    with pytest.raises(SanitizeError):
        run_coral_batch(sp, bad, lp, tg, seeds=(0,), iters=9, window=6, device="cpu")
    monkeypatch.delenv("REPRO_CHECKIFY")
    (ep,) = run_coral_batch(sp, bad, lp, tg, seeds=(0,), iters=9, window=6, device="cpu")
    assert np.isnan(ep.taus).all()
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    with pytest.raises(SanitizeError):
        run_coral_batch(sp, bad, lp, tg, seeds=(0,), iters=9, window=6, device="cpu")


def test_checkify_engine_smoke_clean(monkeypatch, cell):
    sp, lt, lp, tg = cell
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    (ep,) = run_coral_batch(sp, lt, lp, tg, seeds=(0,), iters=9, window=6, device="cpu")
    assert np.isfinite(ep.taus).all() and np.isfinite(ep.rewards).all()


def test_checkify_engine_raises_on_poisoned_landscape(monkeypatch, cell):
    # a fully NaN-poisoned latency landscape must fail loudly, not
    # silently propagate into the episode result, in both packages
    sp, lt, lp, tg = cell
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    bad = np.full_like(lt, np.nan)
    with pytest.raises(SanitizeError, match="nan generated .*tau at step 0"):
        run_coral_batch(sp, bad, lp, tg, seeds=(0, 1), iters=9, window=6, device="cpu")
    ref_sp = ref_jetson_like_space()
    ref_lt, ref_lp = ref_jetson_like_simulator(ref_sp).exact_all()
    ref_tg = RefTargets(mode="dual", tau_target=tg.tau_target, p_budget=tg.p_budget)
    with pytest.raises(Exception, match="nan generated"):
        ref_run_coral_batch(ref_sp, np.full_like(np.asarray(ref_lt), np.nan),
                            np.asarray(ref_lp), ref_tg, seeds=(0, 1), iters=9, window=6)


def _run_family(family, pkg_matrix, pkg_sc, pkg_fleet, **device):
    """One small run of ``family`` (the first cell of its matrix tuple,
    seed 0; the fleet at FLEET_KW) through one package; returns its
    record."""
    if family == "fleet":
        return pkg_fleet.run_fleet(seed=0, **FLEET_KW, **device)["results"]
    run, cells = {
        "static": (pkg_matrix.run_static_cell, pkg_sc.enumerate_cells()),
        "drift": (pkg_matrix.run_drift_cell, pkg_sc.MATRIX_DRIFT_CELLS),
        "offload": (pkg_matrix.run_offload_cell, pkg_sc.MATRIX_OFFLOAD_CELLS),
        "cotenant": (pkg_matrix.run_cotenant_cell, pkg_sc.MATRIX_COTENANT_CELLS),
        "fault": (pkg_matrix.run_fault_cell, pkg_sc.MATRIX_FAULT_CELLS),
    }[family]
    return run(cells[0], seeds=(0,), **device)


def _verdict(fn):
    try:
        fn()
    except Exception as e:  # the JAX package raises JaxRuntimeError
        assert "nan generated" in str(e), e
        return "raises"
    return "clean"


@pytest.mark.parametrize("family", FAMILIES)
def test_lane_gives_the_reference_verdict(monkeypatch, family):
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    ref = _verdict(lambda: _run_family(family, ref_matrix, ref_sc, ref_fleet))
    port = _verdict(lambda: _run_family(family, matrix, sc, fleet, device="cpu"))
    assert port == ref == ("raises" if family == "fault" else "clean")


def _counted_run(monkeypatch, family, lane):
    """The port's record of ``family`` with the NaN lane ``lane`` and the
    number of dCor window calls it made."""
    if lane:
        monkeypatch.setenv("REPRO_CHECKIFY", "1")
    else:
        monkeypatch.delenv("REPRO_CHECKIFY", raising=False)
    calls, real = [0], core_dcov.dcov_gram_windows

    def counted(cols, n_valid):
        calls[0] += 1
        return real(cols, n_valid)

    with mock.patch.object(core_dcov, "dcov_gram_windows", counted):
        rec = _run_family(family, matrix, sc, fleet, device="cpu")
    return json.loads(json.dumps(rec, sort_keys=True, default=str)), calls[0]


@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "fault"])
def test_lane_on_and_off_give_identical_records(monkeypatch, family):
    off, off_calls = _counted_run(monkeypatch, family, lane=False)
    on, on_calls = _counted_run(monkeypatch, family, lane=True)
    assert on == off
    assert on_calls == off_calls > 0


def test_fault_cell_raises_and_names_the_dropped_telemetry(monkeypatch):
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    with pytest.raises(SanitizeError, match="nan generated .*tau at step"):
        matrix.run_fault_cell(sc.MATRIX_FAULT_CELLS[0], seeds=(0,), device="cpu")
    # lane off, the cell's record is the one the matrix holds to the record
    monkeypatch.delenv("REPRO_CHECKIFY")
    rec = matrix.run_fault_cell(sc.MATRIX_FAULT_CELLS[0], seeds=(0,), device="cpu")
    assert rec["hardened"]["n_runs"] == 1


def test_static_matrix_builds_once(cell):
    sp, lt, lp, tg = cell
    # unique (iters, window) so this spec is cold in-process no matter
    # which tests ran before
    kw = dict(iters=13, window=5, device="cpu")
    with sanitize.count_builds() as cold:
        run_coral_batch(sp, lt, lp, tg, seeds=(0, 1), **kw)
    assert cold.count("stage") == 1 and cold.total == 1, cold.names
    # same spec, fresh data: nothing staged, built or captured
    with sanitize.count_builds() as warm:
        run_coral_batch(sp, lt, lp, tg, seeds=(2, 3), **kw)
    assert warm.total == 0, warm.names


def test_fleet_path_builds_once():
    """Two stagings, as the reference compiles two executables, but for
    another reason: a spec is keyed on the batch's distinct spaces (not
    on B), and the warm re-run of the cohort's twin spans fewer spaces
    than the cold call over all four twins, so the two calls are two
    EngineSpecs. The same fleet path with another seed builds nothing."""
    calls, real = [], fleet.run_fleet_requests

    def keep(reqs, *args, **kw):
        calls.append(episode._batch_spaces(reqs))
        return real(reqs, *args, **kw)

    with sanitize.count_builds() as cold, mock.patch.object(fleet, "run_fleet_requests", keep):
        fleet.run_fleet(seed=0, **GUARD_FLEET_KW, device="cpu")
    assert len(calls) == 2 and calls[0] != calls[1]
    assert cold.count("stage") == 2 and cold.total == 2, cold.names
    with sanitize.count_builds() as warm:
        fleet.run_fleet(seed=1, **GUARD_FLEET_KW, device="cpu")
    assert warm.total == 0, warm.names


def test_guard_counts_kernel_builds_and_captures(monkeypatch):
    monkeypatch.setitem(runtime.BUILD_LOG, "dcov", {"seconds": 0.0, "log": ""})
    monkeypatch.setattr(serving_engine, "_CAPTURES", serving_engine._CAPTURES.copy())
    serving_engine._CAPTURES["qwen"] = 3
    with sanitize.count_builds() as log:
        runtime.BUILD_LOG["ssd_scan"] = {"seconds": 0.0, "log": ""}
        serving_engine._CAPTURES["qwen"] += 2
        serving_engine._CAPTURES["hymba"] += 1
    del runtime.BUILD_LOG["ssd_scan"]
    assert log.count("nvcc:ssd_scan") == 1 and log.count("nvcc:dcov") == 0
    assert log.count("capture:qwen") == 2 and log.count("capture:hymba") == 1
    assert log.total == 4
    # counts reset inside the block: what was captured after the reset
    with sanitize.count_builds() as log:
        serving_engine.reset_capture_counts()
        serving_engine._CAPTURES["qwen"] += 1
    assert log.names == ["capture:qwen"]
