"""The port's CORAL loop against the JAX package, on the CPU: the host-side
pieces copied from it (space, search, reward, baselines, device twins,
scenarios), the float32 Alg. 2 step in both of its branches, the hardened
ingest gate, and the scalar spec ``run_regime`` episode for episode.

Tolerances. Copied numpy code and the records it feeds: exact (``==``).
``alg2_levels``'s torch branch against its numpy branch: bitwise. dCor
reaches the loop as float32 and may differ from XLA's by ulps, so the
loop is held on its decisions (configs, picks) and on the float64
measurements, which are exact.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro.core import faults as ref_faults
from repro.core import search as ref_search
from repro.core.coral import CORAL as RefCORAL
from repro.core.episode import measurement_noise as ref_measurement_noise
from repro.core.evaluate import run_regime as ref_run_regime
from repro.core.space import jetson_like_space as ref_jetson_like_space
from repro.device.simulator import jetson_like_simulator as ref_jetson_like_simulator
from repro.experiments import scenarios as ref_sc
from repro_torch.core import baselines, search
from repro_torch.core.coral import CORAL
from repro_torch.core.episode import measurement_noise
from repro_torch.core.evaluate import run_regime
from repro_torch.core.faults import RobustConfig, mad_reject_trace
from repro_torch.core.space import jetson_like_space
from repro_torch.device.simulator import jetson_like_simulator
from repro_torch.experiments import scenarios as sc

SEEDS = (0, 1, 2)
DUAL_CELL = sc.Cell("edge-xavier-nx", "qwen2.5-3b", "decode_steady", "strict_dual")
THROUGHPUT_CELL = sc.Cell("edge-orin-nano", "granite-8b", "decode_steady", "max_throughput")


def ref_cell(cell):
    return ref_sc.Cell(*cell.key())


def same(a, b):
    """Dataclass values of the two packages (Outcome, RegimeTargets) agree
    field for field."""
    return dataclasses.astuple(a) == dataclasses.astuple(b)


def episode_consts(space):
    """alg2_levels' per-space constant arguments, numpy."""
    return (
        search.dim_notches(space, True),
        search.padded_ladders(space),
        np.asarray([len(d.values) for d in space.dims], np.int32),
        search.role_mask(space, ("host_cores", "cpu_cores")),
        search.role_mask(space, ("concurrency",)),
    )


def both_branches(space, x, y, gamma, aside, down, probe, tau_best, p_best, tau_target):
    """alg2_levels over B rows: the numpy branch row by row, the torch
    branch on the whole batch."""
    notches, ladders, n_levels, cores, conc = episode_consts(space)
    b = x.shape[0]
    want = np.stack([
        search.alg2_levels(
            np, x[i], y[i], gamma[i], notches, ladders, n_levels, np.bool_(aside[i]),
            np.bool_(down[i]), np.bool_(probe[i]), np.float32(tau_best[i]),
            np.float32(p_best[i]), np.float32(tau_target[i]), np.float32(0.0), cores, conc)
        for i in range(b)
    ])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def rep(a):
        return t(np.broadcast_to(a, (b,) + a.shape))

    got = search.alg2_levels(
        torch, t(x), t(y), t(gamma), rep(notches), rep(ladders), rep(n_levels), t(aside),
        t(down), t(probe), t(tau_best), t(p_best), t(tau_target),
        torch.tensor(0.0, dtype=torch.float32), rep(cores), rep(conc))
    return want, got.numpy()


@pytest.mark.parametrize("kind", ["xavier_nx", "orin_nano"])
def test_alg2_torch_branch_equals_numpy_branch_on_random_inputs(kind):
    space = jetson_like_space(kind)
    grid = space.grid().astype(np.float32)
    rng = np.random.default_rng(0)
    b = 256
    x, y = grid[rng.integers(0, len(grid), b)], grid[rng.integers(0, len(grid), b)]
    gamma = rng.random((b, len(space.dims))).astype(np.float32)
    flags = rng.random((3, b)) < 0.5
    scal = rng.uniform(0.0, 20.0, (3, b)).astype(np.float32)
    want, got = both_branches(space, x, y, gamma, *flags, *scal)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # the numpy branch is the reference's, op for op
    notches, ladders, n_levels, cores, conc = episode_consts(space)
    for i in range(0, b, 17):
        ref = ref_search.alg2_levels(
            np, x[i], y[i], gamma[i], notches, ladders, n_levels, np.bool_(flags[0, i]),
            np.bool_(flags[1, i]), np.bool_(flags[2, i]), scal[0, i], scal[1, i], scal[2, i],
            np.float32(0.0), cores, conc)
        assert np.array_equal(ref, want[i])


def test_alg2_torch_branch_equals_numpy_branch_at_ladder_midpoints():
    """v lands exactly halfway between two levels (x = y, γ = 0.5: the
    step is half a notch): both branches take the lower level."""
    space = jetson_like_space("xavier_nx")
    grid = space.grid().astype(np.float32)
    rng = np.random.default_rng(1)
    b = 128
    x = grid[rng.integers(0, len(grid), b)]
    gamma = np.full((b, len(space.dims)), 0.5, np.float32)
    down = rng.random(b) < 0.5
    zeros = np.zeros(b, bool)
    scal = np.zeros((3, b), np.float32)
    want, got = both_branches(space, x, x.copy(), gamma, zeros, down, zeros, *scal)
    assert np.array_equal(got, want)
    # the tie really is a tie, and it resolves to the lower level
    cpu = np.asarray(space.dims[0].values, np.float32)
    lev = int(np.searchsorted(cpu, x[0, 0]))
    notch = search.dim_notches(space, True)[0]
    v = x[0, 0] + (-1 if down[0] else 1) * np.float32(0.5) * notch
    if 0 < lev < len(cpu) - 1:
        d = np.abs(cpu - v)
        assert np.sum(d == d.min()) == 2 and got[0, 0] == np.argmin(d)


@pytest.mark.parametrize("device", ["edge-xavier-nx", "edge-orin-nano"])
@pytest.mark.parametrize("model", ["qwen2.5-3b", "granite-8b", "internlm2-20b"])
@pytest.mark.parametrize("workload", ["decode_steady", "prefill_steady"])
def test_landscapes_equal_the_reference(device, model, workload):
    cell = sc.Cell(device, model, workload, "strict_dual")
    tau, p = sc.cell_simulator(cell, noise=0.0).exact_all()
    rtau, rp = ref_sc.cell_simulator(ref_cell(cell), noise=0.0).exact_all()
    assert np.array_equal(tau, rtau) and np.array_equal(p, rp)
    assert same(sc.resolve_targets(cell), ref_sc.resolve_targets(ref_cell(cell)))


def test_enumerated_cells_equal_the_reference():
    got = [c.key() for c in sc.enumerate_cells(workloads=sc.FULL_MATRIX_WORKLOADS)]
    want = [c.key() for c in ref_sc.enumerate_cells(workloads=ref_sc.FULL_MATRIX_WORKLOADS)]
    assert got == want and len(got) == 54


@pytest.mark.parametrize("seed,noise", [(0, 0.02), (7, 0.04)])
def test_measurement_noise_equals_the_reference_draw_for_draw(seed, noise):
    assert np.array_equal(measurement_noise(seed, noise, 10),
                          ref_measurement_noise(seed, noise, 10))
    twin = sc.cell_simulator(DUAL_CELL, noise=noise, seed=seed)
    ref_twin = ref_sc.cell_simulator(ref_cell(DUAL_CELL), noise=noise, seed=seed)
    rng = np.random.default_rng(seed)
    for row in twin.space.grid()[rng.integers(0, twin.space.size(), 12)]:
        assert twin.measure(tuple(row)) == ref_twin.measure(tuple(row))
    assert all(np.array_equal(a, b) for a, b in zip(twin.measure_all(), ref_twin.measure_all()))


@pytest.mark.parametrize("cell", [DUAL_CELL, THROUGHPUT_CELL], ids=["dual", "throughput"])
def test_baselines_equal_the_reference(cell):
    targets = sc.resolve_targets(cell)
    t, p = targets.tau_target, targets.p_budget
    sim0 = sc.cell_simulator(cell, noise=0.0)
    ref_sim0 = ref_sc.cell_simulator(ref_cell(cell), noise=0.0)
    space = sim0.space
    assert same(baselines.oracle(space, sim0, t, p), ref_baselines.oracle(space, ref_sim0, t, p))
    assert same(baselines.oracle_scalar(space, sim0, t, p),
                ref_baselines.oracle_scalar(space, ref_sim0, t, p))
    assert same(baselines.oracle_max_throughput(space, sim0),
                ref_baselines.oracle_max_throughput(space, ref_sim0))

    def twins(seed):
        return (sc.cell_simulator(cell, seed=seed),
                ref_sc.cell_simulator(ref_cell(cell), seed=seed))

    a, b = twins(101)
    assert same(baselines.alert(space, a, t, p), ref_baselines.alert(space, b, t, p))
    a, b = twins(102)
    assert same(baselines.alert_online(space, a, t, p, seed=102),
                ref_baselines.alert_online(space, b, t, p, seed=102))
    for kind in ("max_power", "default", "min_power"):
        a, b = twins(103)
        assert same(baselines.preset(space, a, kind), ref_baselines.preset(space, b, kind))


@pytest.mark.parametrize("cell", [DUAL_CELL, THROUGHPUT_CELL], ids=["dual", "throughput"])
@pytest.mark.parametrize("seed", SEEDS)
def test_run_regime_equals_the_reference(cell, seed):
    targets = sc.resolve_targets(cell)
    space = sc.cell_simulator(cell, noise=0.0).space
    out, tr = run_regime(space, sc.cell_simulator(cell, seed=seed), targets, seed=seed,
                         device="cpu")
    ref_out, ref_tr = ref_run_regime(space, ref_sc.cell_simulator(ref_cell(cell), seed=seed),
                                     ref_sc.resolve_targets(ref_cell(cell)), seed=seed)
    assert [tuple(c) for c in tr.configs] == [tuple(c) for c in ref_tr.configs]
    assert tr.taus == ref_tr.taus and tr.powers == ref_tr.powers
    assert tr.rewards == ref_tr.rewards
    assert same(out, ref_out)


def test_coral_correlations_equal_the_reference():
    """Step 2 on a partial window: α, β within float32 reordering (1e-6)."""
    space = jetson_like_space()
    opt = CORAL(space, tau_target=10.0, p_budget=100.0, window=10, device="cpu")
    ref = RefCORAL(space, tau_target=10.0, p_budget=100.0, window=10)
    rng = np.random.default_rng(0)
    for _ in range(7):
        cfg = space.random(rng)
        tau, p = 10 + rng.random() * 5, 50 + rng.random() * 10
        opt.observe(cfg, tau, p)
        ref.observe(cfg, tau, p)
    for got, want in zip(opt.correlations(), ref.correlations()):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mad_gate_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 11))
    win = np.zeros((2, 10), np.float32)
    win[:, :n] = rng.uniform(1.0, 20.0, (2, n))
    for tau, p in [(win[0, :max(n, 1)].mean() or 5.0, 3.0), (1e4, 3.0), (5.0, 1e-3)]:
        want = bool(ref_faults.mad_reject(
            jnp.asarray(win[0]), jnp.asarray(win[1]), np.int32(n), np.float32(tau),
            np.float32(p), np.float32(2.5), np.float32(0.7), np.int32(5)))

        def t(v):
            return torch.tensor(np.float32(v))

        got = mad_reject_trace(torch.from_numpy(win[0]), torch.from_numpy(win[1]), n, t(tau),
                               t(p), t(2.5), t(0.7), 5)
        assert got == want


def _robust_pair(seed=5):
    space = jetson_like_space()
    sim = jetson_like_simulator(space, 1.0, noise=0.0)
    taus, powers = sim.exact_all()
    p_budget = float(np.median(powers))
    tau_target = 0.5 * float(taus[powers <= p_budget].max())
    rb = RobustConfig()
    rrb = ref_faults.RobustConfig()
    assert rb == RobustConfig(**vars(rrb))
    return (CORAL(space, tau_target, p_budget, seed=seed, robust=rb, device="cpu"),
            RefCORAL(space, tau_target, p_budget, seed=seed, robust=rrb), space)


def _drive(opt, twin, iters, spikes=()):
    out = []
    for t in range(iters):
        cfg = opt.next_config()
        tau, p = twin.measure(cfg)
        if t in spikes:
            tau *= 1000.0
        opt.record(cfg, tau, p)
        out.append(cfg)
    return out


def test_hardened_coral_equals_the_reference():
    """CORAL with a RobustConfig: the MAD gate rejects the same spiked
    samples, so the command sequences agree."""
    opt, ref, space = _robust_pair()
    spikes = (6, 7, 12)
    got = _drive(opt, jetson_like_simulator(space, 1.0, seed=3, noise=0.05), 30, spikes)
    want = _drive(ref, ref_jetson_like_simulator(ref_jetson_like_space(), 1.0, seed=3,
                                                 noise=0.05), 30, spikes)
    assert got == want
    assert len(opt.state.history) == len(ref.state.history) < 30


def test_checkpoint_round_trips_and_resumes():
    """20 intervals, a JSON round trip into a fresh optimizer, 20 more:
    the same commands as 40 uninterrupted; the checkpoint itself equals
    the reference's at the same point."""
    space = jetson_like_space()
    opt_a, _, _ = _robust_pair()
    seq_a = _drive(opt_a, jetson_like_simulator(space, 1.0, seed=3, noise=0.05), 40)
    opt_b, ref_b, _ = _robust_pair()
    twin_b = jetson_like_simulator(space, 1.0, seed=3, noise=0.05)
    seq_b = _drive(opt_b, twin_b, 20)
    _drive(ref_b, ref_jetson_like_simulator(ref_jetson_like_space(), 1.0, seed=3,
                                            noise=0.05), 20)
    blob = json.dumps(opt_b.to_checkpoint(), sort_keys=True)
    assert blob == json.dumps(ref_b.to_checkpoint(), sort_keys=True)
    opt_c, _, _ = _robust_pair()
    opt_c.restore(json.loads(blob))
    assert json.dumps(opt_c.to_checkpoint(), sort_keys=True) == blob
    seq_b += _drive(opt_c, twin_b, 20)
    assert seq_b == seq_a
    assert same(opt_c.result(), opt_a.result())


def _exports(package):
    """The names a package's ``__init__`` binds, submodules left out."""
    import types

    return {name for name, v in vars(package).items()
            if not name.startswith("_") and not isinstance(v, types.ModuleType)}


def test_core_exports_what_the_reference_exports():
    import repro.core
    import repro_torch.core
    from repro_torch.core import evaluate

    assert _exports(repro.core) <= _exports(repro_torch.core)
    assert evaluate.run_coral_scalar is evaluate.run_coral
    assert evaluate.run_drift_regime_scalar is evaluate.run_drift_regime
