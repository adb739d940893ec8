"""``serving/controller.py`` against the JAX package's: each controller
over its own copy of one scripted runtime (knobs readable, interval
metrics a fixed function of the knobs and the interval index, no wall
clock), the same trace, targets and seed. The ``IntervalRecord``s, the
outcome, what each runtime was asked to do (the trace releases, the
knob writes, the backoff sleeps) and the checkpoint must be equal,
exactly: the controller's arithmetic is the same float64 numpy in both
packages, and CORAL's windowed dCor on the CPU (the dcov kernel's plain
version, float32) gives the reference's decisions (tests/test_torch_coral.py).
Covered: dual and throughput modes, a drift schedule, a robust
controller with a stuck concurrency knob and a recording sleeper, a
cotenant space and an offload space; the checkpoint dict, its JSON round
trip and a resumed run; ``build_serving_record``.
"""
import dataclasses
import json

import numpy as np
import pytest

import repro.core.space as jax_space
import repro.device.hw as jax_hw
import repro.device.network as jax_network
import repro.serving.controller as jax_controller
import repro.serving.workload as jax_workload
from repro.core.faults import RobustConfig as JaxRobust
import repro_torch.core.space as space_mod
import repro_torch.device.hw as hw_mod
import repro_torch.device.network as network_mod
import repro_torch.serving.controller as controller_mod
import repro_torch.serving.workload as workload_mod
from repro_torch.core.faults import RobustConfig

PKG = {
    "port": (space_mod, hw_mod, network_mod, controller_mod, workload_mod, RobustConfig),
    "jax": (jax_space, jax_hw, jax_network, jax_controller, jax_workload, JaxRobust),
}


class _Ring:
    def __init__(self, slot_budget, tau_floor):
        self.slot_budget = slot_budget
        self.tau_floor = tau_floor


class ScriptedRuntime:
    """A runtime double: every knob write is logged and (but for the first
    ``stuck`` concurrency writes, which are dropped) takes; ``run_for``
    advances a scripted clock and returns metrics that depend only on the
    knobs in force and the interval index."""

    def __init__(self, tenants=(), stuck=0):
        self.tenants = {n: _Ring(1, floor) for n, floor in tenants}
        self.concurrency = 1
        self.rate_scale = 1.0
        self.clock = 0.0
        self.intervals = 0
        self.stuck = stuck
        self.log = []

    def attach_pod(self, network, pod_time_per_token=2e-3):
        self.log.append(("attach_pod", network.name, pod_time_per_token))

    def set_offload(self, phi):
        self.log.append(("set_offload", phi))

    def set_concurrency(self, c):
        self.log.append(("set_concurrency", c))
        if self.stuck > 0:
            self.stuck -= 1
        else:
            self.concurrency = max(1, int(c))

    def set_rate_scale(self, s):
        self.log.append(("set_rate_scale", s))
        self.rate_scale = min(1.0, max(0.05, float(s)))

    def set_slot_allocation(self, alloc):
        self.log.append(("set_slot_allocation", dict(alloc)))
        for n, c in alloc.items():
            self.tenants[n].slot_budget = max(1, int(c))

    def submit(self, req, tenant=None):
        self.log.append(("submit", req.rid, tenant))

    def now(self):
        return self.clock

    def _tau(self, slots):
        wobble = 1.0 + 0.05 * ((7 * self.intervals) % 5)
        return 40.0 * slots ** 0.7 * self.rate_scale * wobble

    def run_for(self, seconds, idle_wait=False):
        self.log.append(("run_for", seconds, idle_wait))
        self.clock += seconds
        self.intervals += 1
        k = self.intervals
        return {"throughput_tok_s": self._tau(self.concurrency), "requests": 3 + k % 4,
                "queue_depth": (5 * k) % 7, "p50_latency_s": 0.1 + 0.01 * k,
                "p99_latency_s": 0.2 + 0.02 * k}

    def tenant_metrics(self, window_s=None):
        return {n: {"throughput_tok_s": self._tau(r.slot_budget) * (1 + i)}
                for i, (n, r) in enumerate(self.tenants.items())}


def _trace(pkg):
    wl = PKG[pkg][4]
    return wl.bursty_poisson(rate=12.0, duration_s=8.0, prompt_lens=(8, 12), new_tokens=4,
                             vocab=128, seed=1)


def _build(pkg, case):
    """A controller of package ``pkg`` for one scenario, and its runtime."""
    space, hw, network, ctl, _, robust = PKG[pkg]
    kw = dict(interval_s=0.5, seed=3)
    if pkg == "port":
        kw["device"] = "cpu"
    sleeps = []
    if case == "cotenant":
        rt = ScriptedRuntime(tenants=(("default", 30.0), ("b", 20.0)))
        sp = space.cotenant_space("edge_xavier_nx", 2)
        c = ctl.ServingController(rt, sp, _trace(pkg), tau_target=1.0, p_budget=1e9,
                                  hw=hw.get_profile("edge-xavier-nx").hw, **kw)
        return c, rt, sleeps
    if case == "offload":
        rt = ScriptedRuntime()
        sp = space.offload_space("edge_xavier_nx")
        prof = hw.get_profile("edge-xavier-nx")
        c = ctl.ServingController(rt, sp, _trace(pkg), tau_target=30.0, p_budget=1e9,
                                  profile=prof, network=network.get_network("lte-uplink"),
                                  **kw)
        return c, rt, sleeps
    sp = space.tpu_pod_space()
    p_budget = 0.8 * ctl.analytic_scale_and_power(sp.names, sp.preset("max_power"))[1]
    rt = ScriptedRuntime(stuck=4 if case == "robust" else 0)
    if case == "throughput":
        kw["mode"] = "throughput"
    if case == "drift":
        kw["drift_schedule"] = hw.DriftSchedule(events=(
            hw.ThermalRamp(start=3, duration=4), hw.BudgetStep(start=6, scale=0.85)))
    if case == "robust":
        kw["robust"] = robust(act_retries=2, backoff_s=0.05)
        kw["sleeper"] = sleeps.append
    c = ctl.ServingController(rt, sp, _trace(pkg), tau_target=60.0, p_budget=p_budget, **kw)
    return c, rt, sleeps


CASES = ["dual", "throughput", "drift", "robust", "cotenant", "offload"]


def _records(recs):
    return [dataclasses.asdict(r) for r in recs]


@pytest.mark.parametrize("case", CASES)
def test_controller_equals_the_reference(case):
    out = {}
    for pkg in ("port", "jax"):
        c, rt, sleeps = _build(pkg, case)
        outcome, recs = c.run(10)
        out[pkg] = (outcome, _records(recs), rt.log, sleeps, c.actuation_failures,
                    json.dumps(c.checkpoint(), sort_keys=True))
    (o, r, log, sl, fails, ck), (jo, jr, jlog, jsl, jfails, jck) = out["port"], out["jax"]
    assert r == jr
    assert (o.config, o.tau, o.power, o.measurements) == (
        jo.config, jo.tau, jo.power, jo.measurements)
    assert log == jlog and sl == jsl and fails == jfails
    assert ck == jck
    if case == "robust":
        assert fails > 0 and sl[:2] == [0.05, 0.1]
    if case == "cotenant":
        assert all(set(x["tenant_taus"]) == {"default", "b"} for x in r)
    if case == "offload":
        assert log[0][0] == "attach_pod" and any(e[0] == "set_offload" for e in log)


def test_checkpoint_round_trip_resumes_identically(tmp_path):
    """Ten intervals straight against five, a checkpoint through a file
    (JSON), a fresh controller restored from it, and five more."""
    straight, _, _ = _build("port", "robust")
    straight.run(10)
    first, rt, _ = _build("port", "robust")
    first.run(5)
    path = tmp_path / "controller.ckpt.json"
    first.save_checkpoint(path)
    assert not path.with_suffix(".json.tmp").exists()  # written atomically
    ck = json.loads(path.read_text())
    assert ck["version"] == 1 and len(ck["records"]) == 5
    resumed, _, _ = _build("port", "robust")
    resumed.runtime, resumed.workload, resumed._pending = rt, first.workload, first._pending
    resumed.restore_checkpoint(path)
    assert json.dumps(resumed.checkpoint(), sort_keys=True) == json.dumps(
        first.checkpoint(), sort_keys=True)
    resumed.run(5)
    assert _records(resumed.records) == _records(straight.records)
    with pytest.raises(ValueError, match="checkpoint version"):
        resumed.restore({"version": 2})


def test_restore_takes_the_references_checkpoint():
    c, _, _ = _build("port", "dual")
    jc, _, _ = _build("jax", "dual")
    jc.run(6)
    c.restore(json.loads(json.dumps(jc.checkpoint())))
    assert json.dumps(c.checkpoint(), sort_keys=True) == json.dumps(jc.checkpoint(),
                                                                     sort_keys=True)


def test_build_serving_record_equals_the_reference():
    recs = {}
    for pkg in ("port", "jax"):
        c, _, _ = _build(pkg, "dual")
        outcome, records = c.run(6)
        curve = {1: 100.0, 2: 150.0, 3: 170.0, 4: 171.0, 5: 168.5}
        for include in (False, True):
            recs[pkg, include] = PKG[pkg][3].build_serving_record(
                "regen", [1, 2, 3, 4, 5], curve, 2, batch_size=4, iters=6, interval_s=0.5,
                tau_target=60.0, p_budget=c.p_budget, outcome=outcome, records=records,
                include_intervals=include)
    for include in (False, True):
        assert json.dumps(recs["port", include], sort_keys=True) == json.dumps(
            recs["jax", include], sort_keys=True)
    assert len(recs["port", True]["results"]["closed_loop_bursty"]["intervals"]) == 6


def test_controller_guards_match_the_reference():
    for pkg in ("port", "jax"):
        space, hw, network, ctl, _, _ = PKG[pkg]
        kw = {"device": "cpu"} if pkg == "port" else {}
        with pytest.raises(ValueError, match="ConfigSpace or a DeviceProfile"):
            ctl.ServingController(ScriptedRuntime(), None, [], tau_target=1.0, **kw)
        sp = space.cotenant_space("edge_xavier_nx", 2)
        with pytest.raises(ValueError, match="tenant rings"):
            ctl.ServingController(ScriptedRuntime(tenants=(("a", 1.0),)), sp, [],
                                  tau_target=1.0, **kw)
        with pytest.raises(ValueError, match="tau_floor"):
            ctl.ServingController(ScriptedRuntime(tenants=(("a", 1.0), ("b", 0.0))), sp, [],
                                  tau_target=1.0, **kw)
