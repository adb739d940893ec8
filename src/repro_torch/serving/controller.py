"""Closed-loop CORAL over the live serving runtime (the counterpart of
``repro/serving/controller.py``).

Port notes: the optimizer is the port's ``core.coral.CORAL``, whose
windowed dCor runs where ``device`` says (on the card, the dcov kernel);
the runtime's decode steps are the engine's CUDA graph replays on the
card; power is the reference's analytical model on ``DEFAULT_HW`` (the
TPU v5e constants), not a reading of the card's rail.

The paper's evaluation loop (Fig. 2) — optimizer proposes a config, the
device applies it, measured (τ, p) feed back — wired to real traffic
instead of a device model: each control interval the controller

  1. applies CORAL's proposed config to the runtime (the concurrency knob
     is applied *for real* via ``set_concurrency``; the DVFS knobs — no
     clock control in this container — are enacted as pacing via
     ``set_rate_scale``, so a down-clocked config genuinely serves slower
     and its backlog genuinely grows; power stays analytical, the same
     split as ``WalltimeDevice``),
  2. releases the next ``interval_s`` worth of workload-trace arrivals
     into the runtime's pool,
  3. serves one wall-clock control interval and observes its windowed
     (τ, p), which CORAL's reward/correlation machinery consumes.

Under a bursty trace the queue builds up during under-provisioned
intervals, so infeasible configs are penalized by what they actually did
to live traffic — not by a model of what they would have done.

With a ``drift_schedule`` the live intervals carry the drift clock
(EXPERIMENTS.md §Drift): each control interval reads the schedule's
operating condition, enacts the derated delivered rate and inflated rail
draw on real traffic, relays commanded budget steps to the optimizer,
and lets CORAL's change-point monitor watch the held config between
exploration epochs.

With a ``network`` the controller tunes an *offload-aware* space
(EXPERIMENTS.md §Offload): the ``offload_frac`` knob is enacted for
real — the runtime's admission pool routes that fraction of requests
to the pod — while the analytical rail model keeps pricing the edge
knobs only (placement dims are stripped, the radio's hold-active draw
is added whenever φ > 0, per-token ship energy is metered live by the
runtime). Offload and drift schedules are mutually exclusive for now:
drifted-rate pacing would double-count the routed fraction.

Over a *cotenant* space (``core.space.cotenant_space`` — per-tenant
``slots_t<k>`` dims beside the shared DVFS knobs, EXPERIMENTS.md
§Multi-tenant) the controller drives one multi-tenant runtime: each
slot dim is enacted on the matching tenant ring in registration order
(``set_slot_allocation``), the shared DVFS knobs pace every ring
alike, and the measured feedback is the *joint headroom* — each ring's
windowed τ over its ``tau_floor``, scalarized by
``core.coral.joint_headroom`` so CORAL's dual mode tunes all tenants
against ``tau_target=1.0`` plus the one shared power cap.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Iterable, List, Optional, Tuple

from repro_torch.core.baselines import Outcome
from repro_torch.core.coral import CORAL, joint_headroom
from repro_torch.core.drift import DriftConfig
from repro_torch.core.faults import RobustConfig
from repro_torch.core.space import (
    CONCURRENCY_DIM,
    OFFLOAD_DIM,
    TENANT_SLOT_PREFIX,
    ConfigSpace,
    tenant_slot_indices,
)
from repro_torch.device.hw import (
    DEFAULT_HW,
    DeviceProfile,
    DriftSchedule,
    TPUv5eSpec,
)
from repro_torch.device.measure import analytic_scale_and_power
from repro_torch.serving.runtime import Request, ServingRuntime


@dataclasses.dataclass
class IntervalRecord:
    """One control interval: what was applied and what the traffic saw."""

    config: tuple
    tau: float  # measured tok/s over the interval (joint headroom when
    # the tuned space is cotenant), DVFS-scaled
    power: float  # analytical pod power at this config
    reward: float
    requests_done: int
    queue_depth: int  # backlog left when the interval ended
    p50_latency_s: float
    p99_latency_s: float
    # cotenant spaces only: each ring's windowed tok/s this interval
    tenant_taus: Optional[dict] = None


class ServingController:
    """The closed loop: one CORAL optimizer driving one live runtime.

    Built either from an explicit ``ConfigSpace`` + the hand-wired HW
    constants, or from a ``DeviceProfile`` (the scenario-matrix unit),
    which supplies both. With a ``network`` it tunes an offload-aware
    space: the ``offload_frac`` knob is enacted for real at the
    runtime's admission pool (EXPERIMENTS.md §Offload), and the radio's
    hold-active draw joins the analytical edge-rail power whenever the
    link carries traffic.
    """

    def __init__(
        self,
        runtime: ServingRuntime,
        space: Optional[ConfigSpace],
        workload: Iterable[Request],
        tau_target: float,
        p_budget: float = float("inf"),
        interval_s: float = 0.5,
        hw: TPUv5eSpec = DEFAULT_HW,
        mode: str = "dual",
        seed: int = 0,
        window: int = 10,
        profile: Optional[DeviceProfile] = None,
        drift_schedule: Optional[DriftSchedule] = None,
        drift: Optional[DriftConfig] = None,
        network=None,  # NetworkProfile: attach the edge↔pod uplink
        pod_time_per_token: float = 2e-3,
        robust: Optional[RobustConfig] = None,
        sleeper: Optional[Callable[[float], None]] = None,
        device="cuda",  # where CORAL's windowed dCor runs
    ):
        # An injected device profile supplies both the knob grid and the
        # power-model constants — the serving loop tunes whatever target
        # the scenario matrix describes, not only the hand-wired default.
        if profile is not None:
            hw = profile.hw
            if space is None:
                space = profile.space()
        if space is None:
            raise ValueError("pass a ConfigSpace or a DeviceProfile")
        self.profile = profile
        self.runtime = runtime
        self.space = space
        self.workload = iter(workload)
        self.interval_s = interval_s
        self.hw = hw
        self.tau_target = tau_target
        self.p_budget = p_budget
        # Live intervals carry the drift clock: each control interval is
        # one tick of the schedule, so thermal ramps / co-tenant steps /
        # budget steps land on real traffic at the interval they name.
        # A schedule without an explicit DriftConfig still gets a
        # monitoring-enabled optimizer — drift without detection would
        # silently degrade the held config.
        self.drift_schedule = drift_schedule
        if drift is None and drift_schedule is not None:
            drift = DriftConfig()
        # Hardened mode (EXPERIMENTS.md §Fault tolerance): the optimizer
        # gets the robust ingest gate + telemetry watchdog, and the
        # controller verifies every knob it enacts by readback with
        # bounded retry + exponential backoff. ``sleeper`` is the backoff
        # clock — injectable so tests run without wall-clock sleeps.
        self.robust = robust
        self._sleep = sleeper if sleeper is not None else time.sleep
        self.actuation_failures = 0  # knobs still mismatched after retries
        self.opt = CORAL(
            space,
            tau_target,
            p_budget,
            window=window,
            seed=seed,
            mode=mode,
            drift=drift,
            robust=robust,
            device=device,
        )
        self.records: List[IntervalRecord] = []
        self._pending: Optional[Request] = None
        # Cotenant spaces trade the single concurrency knob for per-tenant
        # slot dims; exactly one of the two shapes is present.
        self._c_index = (
            space.index(CONCURRENCY_DIM)
            if CONCURRENCY_DIM in space.names
            else None
        )
        self._slot_indices = tenant_slot_indices(space)
        if self._slot_indices:
            rings = list(runtime.tenants.values())
            if len(rings) != len(self._slot_indices):
                raise ValueError(
                    f"space has {len(self._slot_indices)} tenant slot dims "
                    f"but the runtime has {len(rings)} tenant rings; "
                    "add_tenant each co-served model before building the "
                    "controller (slot dim k drives ring k in registration "
                    "order)"
                )
            if any(r.tau_floor <= 0.0 for r in rings):
                raise ValueError(
                    "cotenant control scores joint headroom τ_k/floor_k: "
                    "every tenant ring needs a positive tau_floor"
                )
            if drift_schedule is not None:
                raise ValueError(
                    "cotenant serving and device-drift schedules are not "
                    "combined yet; tune one axis at a time"
                )
        # Offload-aware spaces expose the route-fraction knob; when the
        # tuned space carries it, attach the uplink so admission can
        # genuinely ship requests (see ServingRuntime.set_offload).
        self.network = network
        self._phi_index = (
            space.index(OFFLOAD_DIM) if OFFLOAD_DIM in space.names else None
        )
        if self._phi_index is not None and network is None:
            raise ValueError(
                "the tuned space has an offload_frac knob; pass a "
                "NetworkProfile so admission can route to the pod"
            )
        if self._phi_index is not None and drift_schedule is not None:
            raise ValueError(
                "offload-aware serving and device-drift schedules are not "
                "combined yet; tune one axis at a time"
            )
        if network is not None:
            runtime.attach_pod(network, pod_time_per_token=pod_time_per_token)

    def _submit_until(self, horizon_s: float) -> None:
        """Release trace arrivals with offsets inside the next interval."""
        if self._pending is not None:
            pending_at = self._pending.arrival_s
            if pending_at is not None and pending_at > horizon_s:
                return
            self.runtime.submit(self._pending, self._pending.tenant)
            self._pending = None
        for r in self.workload:
            if r.arrival_s is not None and r.arrival_s > horizon_s:
                self._pending = r
                return
            # multi-tenant traces pre-stamp each request's tenant; None
            # lands on the default ring (single-tenant traces unchanged)
            self.runtime.submit(r, r.tenant)

    def _verified_apply(self, setter, getter, value, matches=None) -> bool:
        """Enact one knob and verify it took, by readback.

        Actuation on a real board can silently stick (the write is rejected,
        or firmware holds the old value); attributing the
        interval's residual to the *commanded* config then poisons the
        correlation window. Write → read back → compare; on mismatch
        retry up to ``robust.act_retries`` times with exponential backoff
        (base ``robust.backoff_s``). Non-robust controllers keep the old
        fire-and-forget single write. Returns whether the readback
        matched; exhausted retries are counted in
        ``actuation_failures`` and the caller attributes to the readback.
        """
        ok = matches if matches is not None else (lambda got: got == value)
        tries = 1 + (self.robust.act_retries if self.robust is not None else 0)
        for attempt in range(tries):
            setter(value)
            if ok(getter()):
                return True
            if self.robust is not None and attempt + 1 < tries:
                self._sleep(self.robust.backoff_s * (2.0 ** attempt))
        self.actuation_failures += 1
        return False

    def control_step(self) -> IntervalRecord:
        """One control interval: propose → apply (concurrency for real,
        DVFS as pacing, placement at admission) → release one interval of
        trace arrivals → serve it on the wall clock → feed the windowed
        (τ, p) back to the optimizer. Returns the interval's record."""
        # the interval index is the drift clock: schedules are defined in
        # control intervals, and each step serves exactly one
        t = len(self.records)
        state = (
            self.drift_schedule.state_at(t)
            if self.drift_schedule is not None
            else None
        )
        if state is not None:
            budget_t = self.p_budget * state.budget_scale
            if budget_t != self.opt.p_budget:
                self.opt.set_p_budget(budget_t)  # commanded, not detected
        cfg = self.opt.next_config()
        names, knob_cfg = self.space.names, cfg
        phi = 0.0
        if self._phi_index is not None:
            # the analytical rail model evaluates the *edge* knobs only:
            # strip the placement dims and pin the host knobs the joint
            # space does not expose at their nominal operating points
            phi = float(cfg[self._phi_index])
            drop = {OFFLOAD_DIM, "pod_tpu_freq"}
            names = [n for n in self.space.names if n not in drop]
            knob_cfg = [
                v for n, v in zip(self.space.names, cfg) if n not in drop
            ]
            names = names + ["host_cpu_freq", "host_cores"]
            knob_cfg = knob_cfg + [self.hw.nominal_host_freq, 6.0]
        slots: List[int] = []
        if self._slot_indices:
            # the shared rail prices total occupancy: strip the per-tenant
            # slot dims and pin concurrency to their sum (host cores fixed
            # at the cotenant twin's operating point, device.cotenant)
            slots = [max(1, int(round(cfg[i]))) for i in self._slot_indices]
            keep = [
                (n, v)
                for n, v in zip(self.space.names, cfg)
                if not n.startswith(TENANT_SLOT_PREFIX)
            ]
            names = [n for n, _ in keep] + ["concurrency", "host_cores"]
            knob_cfg = [v for _, v in keep] + [float(sum(slots)), 6.0]
        dev_rel, power = analytic_scale_and_power(names, knob_cfg, self.hw)
        if self._phi_index is not None:
            # placement is enacted for real at admission; the radio's
            # hold-active draw lands on the edge rail whenever the link
            # carries traffic (per-token ship energy is metered live by
            # the runtime's network_energy_j counter)
            self.runtime.set_offload(phi)
            if phi > 0.0:
                power += self.network.radio_idle_w
        if state is not None and not state.stationary:
            # Enact the drifted operating condition on live traffic: the
            # pacing scale carries the per-level clock derating and the
            # co-tenant's stream contention (host_inflation is not paced —
            # the runtime's host stage is real work, not a dial), and the
            # analytical rail draw carries the extra static power.
            from repro_torch.device.perfmodel import canon

            d = canon(dict(zip(self.space.names, cfg)))
            f_rel = d["tpu_freq"] / self.hw.nominal_tpu_freq
            m_rel = d["hbm_freq"] / self.hw.nominal_hbm_freq
            derate = min(
                1.0 - state.clock_derate * f_rel,
                1.0 - state.mem_derate * m_rel,
            )
            contention = 1.0 + state.kappa_add * (d["concurrency"] - 1.0)
            dev_rel = dev_rel * max(derate, 0.05) / contention
            power = power + state.static_inflation * (
                self.hw.p_idle_chip + self.hw.p_host_idle
            )
        attr_cfg = cfg
        if self._slot_indices:
            # slot dim k drives tenant ring k, in registration order
            alloc = dict(zip(self.runtime.tenants, slots))
            self._verified_apply(
                self.runtime.set_slot_allocation,
                lambda: {
                    n: r.slot_budget for n, r in self.runtime.tenants.items()
                },
                alloc,
            )
        elif self._c_index is not None:
            want_c = max(1, int(cfg[self._c_index]))
            applied = self._verified_apply(
                self.runtime.set_concurrency,
                lambda: self.runtime.concurrency,
                want_c,
            )
            if self.robust is not None and not applied:
                # the knob is stuck: attribute this interval's measurement
                # to the config actually in force, not the commanded one
                attr_cfg = list(cfg)
                attr_cfg[self._c_index] = float(self.runtime.concurrency)
                attr_cfg = tuple(attr_cfg)
        want_scale = min(1.0, max(0.05, float(dev_rel)))
        self._verified_apply(
            self.runtime.set_rate_scale,
            lambda: self.runtime.rate_scale,
            dev_rel,
            matches=lambda got: abs(got - want_scale) < 1e-9,
        )
        self._submit_until(self.runtime.now() + self.interval_s)
        m = self.runtime.run_for(self.interval_s, idle_wait=True)
        tenant_taus = None
        if self._slot_indices:
            # per-ring windowed τ over the just-served interval, scalarized
            # against the rings' floors — CORAL's τ channel is the joint
            # headroom, so dual mode needs no per-tenant plumbing
            tm = self.runtime.tenant_metrics(self.interval_s)
            tenant_taus = {
                n: tm[n]["throughput_tok_s"] for n in self.runtime.tenants
            }
            floors = [
                ring.tau_floor for ring in self.runtime.tenants.values()
            ]
            tau = float(
                joint_headroom(list(tenant_taus.values()), floors)
            )
        else:
            tau = m["throughput_tok_s"]  # pacing already enacted DVFS
        r = self.opt.record(attr_cfg, tau, power)
        rec = IntervalRecord(
            config=tuple(attr_cfg),
            tau=tau,
            power=power,
            reward=r,
            requests_done=int(m["requests"]),
            queue_depth=int(m["queue_depth"]),
            p50_latency_s=m["p50_latency_s"],
            p99_latency_s=m["p99_latency_s"],
            tenant_taus=tenant_taus,
        )
        self.records.append(rec)
        return rec

    def run(self, iters: int = 10) -> Tuple[Outcome, List[IntervalRecord]]:
        """Run ``iters`` control intervals (the paper's 10-measurement
        budget by default) and return CORAL's best feasible pick plus the
        per-interval records."""
        for _ in range(iters):
            self.control_step()
        res = self.opt.result()
        if res is None:
            return Outcome(None, 0.0, 0.0, iters), self.records
        return Outcome(res.config, res.tau, res.power, iters), self.records

    # ------------------------------------------------------------------
    # checkpoint / restore (crash recovery)
    # ------------------------------------------------------------------
    def checkpoint(self) -> dict:
        """JSON-serializable controller state: the full optimizer
        checkpoint (``CORAL.to_checkpoint`` — anchors, history, monitor,
        RNG bit-state) plus the interval ledger. A restarted controller
        built with the same constructor arguments resumes byte-identical
        after ``restore`` (tests/test_torch_controller.py pins the equivalence);
        ``docs/ARCHITECTURE.md`` §Checkpoint format documents the layout.
        """
        return {
            "version": 1,
            "optimizer": self.opt.to_checkpoint(),
            "records": [dataclasses.asdict(r) for r in self.records],
            "actuation_failures": self.actuation_failures,
        }

    def restore(self, ckpt: dict) -> None:
        """Resume from a ``checkpoint()`` dict (or its JSON round-trip)."""
        if ckpt.get("version") != 1:
            raise ValueError(
                f"unknown controller checkpoint version {ckpt.get('version')!r}"
            )
        self.opt.restore(ckpt["optimizer"])
        self.records = [
            IntervalRecord(**{**r, "config": tuple(r["config"])})
            for r in ckpt["records"]
        ]
        self.actuation_failures = int(ckpt["actuation_failures"])

    def save_checkpoint(self, path) -> None:
        """``checkpoint()`` to a file, written atomically (tmp + rename)
        so a crash mid-write can never leave a torn checkpoint behind."""
        import os

        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.checkpoint(), f)
        os.replace(tmp, path)

    def restore_checkpoint(self, path) -> None:
        with open(path) as f:
            self.restore(json.load(f))


def build_serving_record(
    regenerate: str,
    c_values,
    curve,
    rounds: int,
    batch_size: int,
    iters: int,
    interval_s: float,
    tau_target: float,
    p_budget: float,
    outcome: Outcome,
    records: List[IntervalRecord],
    include_intervals: bool = False,
) -> dict:
    """The BENCH_serving.json payload — one schema for every producer
    (benchmarks/serving_bench.py and examples/tune_serving.py), so the
    CI-uploaded artifact's shape does not depend on which ran last."""
    closed = {
        "iters": iters,
        "interval_s": interval_s,
        "tau_target": tau_target,
        "p_budget": p_budget,
        "feasible": outcome.feasible(tau_target, p_budget),
        "config": list(outcome.config) if outcome.config else None,
        "tau": outcome.tau,
        "power": outcome.power,
        "max_queue_depth": max(r.queue_depth for r in records),
    }
    if include_intervals:
        closed["intervals"] = [
            {"config": list(r.config), "tau": r.tau, "power": r.power,
             "reward": r.reward, "queue_depth": r.queue_depth,
             "p99_latency_s": r.p99_latency_s}
            for r in records
        ]
    return {
        "regenerate": regenerate,
        "results": {
            "tau_vs_concurrency": {
                "concurrency": list(c_values),
                "tok_s": [curve[c] for c in c_values],
                "gain_best_c_vs_c1": (
                    max(curve[c] for c in c_values[1:]) / curve[c_values[0]]
                ),
                "batch_size": batch_size,
                "rounds_best_of": rounds,
            },
            "closed_loop_bursty": closed,
        },
    }
