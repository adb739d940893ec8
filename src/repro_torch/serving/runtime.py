"""Continuous-batching serving runtime — per-tenant decode rings over a
shared slot pool (the counterpart of ``repro/serving/runtime.py``).

Port notes. (1) Retire waits on its own slot only: at dispatch the
engine starts a non-blocking copy of the last position's logits into
pinned host memory behind a CUDA event (``ServingEngine.fetch_last``),
and retire waits on that event, where the reference relies on a JAX
device→host transfer skipping the execute queue. (2) A slot binds to one
of the engine's pool caches (``acquire`` / ``release``) for the life of
its group; on the card the engine replays that entry's CUDA graph for
each decode, the port's counterpart of the reference's jitted step.
Whenever slots are set, each engine ``reserve``s one entry per slot of
the rings it serves, so that its captures precede the served traffic.
(3) The loop records itself (``serving/tracing.py``): each request's
``admitted``, ``started``, ``first_token`` and ``finished`` stamps, and
in ``Request.group`` the ``GroupTrace`` of the group that served it,
with its prefill's dispatch and one tuple per retire. The records live
as long as the requests: an operator reads the finished groups as
``{id(r.group): r.group for r in runtime.done}``, the queue wait of a
request as ``r.admitted - runtime._effective_arrival(r)``, a retire's
host time outside its wait as ``t_left - t_ready``. While a profiler
runs, ``serving.*`` ranges name the same steps on the device trace.

The paper (§II-A) tunes concurrency as a first-class resource knob, which
only means anything if ``c`` in-flight decode groups genuinely pipeline.
This runtime serves one or more *tenants* — each a (model engine,
workload trace, τ-floor) triple with its own admission queue, decode
ring and windowed metrics — over shared DVFS pacing and one shared
power rail:

  * each tenant ring holds a request pool with arrival-time admission —
    requests carry an ``arrival_s`` offset (seconds from the shared
    runtime clock start, produced by ``repro.serving.workload`` traces)
    and are only eligible once the serving clock passes it;
  * a ring owns ``slot_budget`` decode *slots*, each holding a
    batch-aligned group with its own KV cache. Slots are visited in ring
    order, and each visit retires the slot's outstanding logits
    (host-side sampling + per-row bookkeeping) and immediately
    re-dispatches its next decode. Because dispatch is asynchronous,
    blocking on slot i's logits happens while the decodes of every other
    in-flight slot — *across all tenants* — are already queued on the
    device: host work overlaps device work, and throughput rises with
    total slots until the device queue saturates (the paper's Fig. 1
    knee). Granting one tenant a slot genuinely slows the others: their
    decodes queue behind it, which is the live analogue of the twin's
    stream-contention kappa (``device.cotenant``);
  * slot refill on completion: rows that reach ``max_new_tokens`` are
    masked out, and when a group's last row finishes the slot re-admits
    a new group from its tenant's pool (group-granularity refill: the KV
    cache keeps one shared ``length`` per group, so rows cannot be
    swapped individually — documented deviation from per-sequence
    refill);
  * rolling-window and per-control-interval (τ, latency) metrics per
    tenant, plus the aggregate — ``run_for`` serves one control interval
    and reports what happened inside it, which is what the closed-loop
    CORAL controller observes; ``tenant_metrics`` exposes the per-ring
    split the multi-tenant controller scores against per-tenant floors;
  * one shared rail: DVFS pacing (``set_rate_scale``) stretches every
    tenant's pass — there is one clock domain — and ``attribute_power``
    splits a measured/modelled rail draw across tenants in proportion to
    their windowed token throughput, summing exactly to the rail total.

A runtime built the old way (``ServingRuntime(engine, ...)``) is the
single-tenant special case: one default ring, with the historical
surface (``waiting`` / ``done`` / ``slots`` / ``submit`` / ``drain``)
delegating to it unchanged. ``add_tenant`` adds rings — each may carry
its *own* engine (a different registry model) — and
``set_slot_allocation`` is the live per-tenant slot knob the joint
CORAL config drives.

Groups are formed from same-prompt-length requests only (no padding to a
neighbour's length), which fixes the old scheduler's silent truncation of
prompts longer than the group head's.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.serving.tracing import GroupTrace, trace_range

# The single-tenant compatibility ring every runtime starts with.
DEFAULT_TENANT = "default"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (prompt_len,)
    max_new_tokens: int
    arrival_s: Optional[float] = None  # offset from clock start; None = now
    arrived: float = dataclasses.field(default_factory=time.monotonic)
    started: float = 0.0  # prefill dispatch time
    finished: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    output: Optional[np.ndarray] = None
    # placement, decided once at admission: None until the request becomes
    # admissible, then "edge" (local slots) or "pod" (shipped upstream)
    route: Optional[str] = None
    # owning tenant ring, stamped at submit
    tenant: Optional[str] = None
    admitted: float = 0.0  # taken into a group (queue wait: admitted - arrival)
    first_token: float = 0.0  # the first served token's stamp
    # the record of the group that served it (serving/tracing.py)
    group: Optional[GroupTrace] = dataclasses.field(default=None, repr=False, compare=False)


class _Slot:
    """One in-flight decode group: KV cache + outstanding logits future."""

    __slots__ = ("group", "trace", "entry", "cache", "logits", "live", "remaining")

    def __init__(self):
        self.group: Optional[List[Request]] = None
        self.trace: Optional[GroupTrace] = None
        self.entry: Optional[int] = None  # the engine's pool entry of this group
        self.cache = None
        self.logits = None  # HostLogits: the outstanding logits' copy to the host
        self.live: List[bool] = []
        self.remaining: List[int] = []


class _TenantRing:
    """One tenant: admission queue, decode slots, windowed metrics.

    The ring owns everything per-tenant — its engine (model), batch
    shape, slot budget, τ-floor, pools and token/event accounting — and
    borrows the shared pieces (clock, pacing, pod seam) from the owning
    ``ServingRuntime``.
    """

    def __init__(
        self,
        name: str,
        runtime: "ServingRuntime",
        engine,
        batch_size: Optional[int] = None,
        slots: int = 1,
        tau_floor: float = 0.0,
    ):
        self.name = name
        self.rt = runtime
        self.engine = engine
        self.batch = int(batch_size or engine.batch)
        self.slot_budget = max(1, int(slots))
        self.tau_floor = float(tau_floor)
        self.waiting: List[Request] = []
        self.done: List[Request] = []
        self.slots: List[_Slot] = []
        self._events: Deque[Tuple[float, int]] = collections.deque()
        self._tokens_total = 0
        self.prefills = 0

    # -------------------------------------------------------------- pool
    def _form_group(self) -> Optional[List[Request]]:
        """FIFO group of admissible requests sharing the head's prompt
        length — equal-length grouping, never pad/clip to another
        request's shape. Pod-routed requests never appear here:
        ``_route_admissible`` removed them from the pool at admission."""
        now = self.rt.now()
        length = None
        picked: List[Request] = []
        for r in self.waiting:
            if r.arrival_s is not None and r.arrival_s > now:
                continue
            if length is None:
                length = r.prompt.size
            if r.prompt.size == length:
                picked.append(r)
                if len(picked) == self.batch:
                    break
        if not picked:
            return None
        admitted = self.rt._t0 + now
        for r in picked:
            r.admitted = admitted
        ids = {id(r) for r in picked}
        self.waiting = [r for r in self.waiting if id(r) not in ids]
        return picked

    # ---------------------------------------------------------- pipeline
    def _start_group(self, slot: _Slot, group: List[Request]) -> None:
        t = time.monotonic()
        with trace_range("serving.prefill"):
            prompts = np.stack([r.prompt for r in group])
            if len(group) < self.batch:
                prompts = np.pad(prompts, ((0, self.batch - len(group)), (0, 0)))
            # async dispatch: the prefill (and its first logits) queue
            # behind whatever the other slots — every tenant's — already
            # have in flight. The last position's copy to the host starts
            # here, not at retire: retire must only ever wait for this
            # slot's own copy — a read there would queue behind every other
            # slot's in-flight decode and serialize the whole ring.
            slot.entry = self.engine.acquire()
            slot.cache, logits = self.engine.prefill(prompts, entry=slot.entry)
            slot.logits = self.engine.fetch_last(logits)
        slot.trace = GroupTrace(self.prefills, slot.entry, len(group), self.batch,
                                prompts.shape[1], t, time.monotonic(),
                                getattr(self.engine, "prefix_tokens", 0))
        for r in group:
            r.started = t
            r.group = slot.trace
        slot.group = group
        slot.live = [True] * len(group)
        slot.remaining = [max(1, int(r.max_new_tokens)) for r in group]
        self.prefills += 1

    def _retire(self, slot: _Slot) -> None:
        """Host stage: block on this slot's logits, sample greedily on the
        host, account tokens/completions, then dispatch the next decode.
        Appends one tuple to the group's ``GroupTrace.retires``."""
        trace = slot.trace
        t_enter = time.monotonic()
        with trace_range("serving.retire"):
            # (B, vocab) float32 logits: waits on *this slot's* copy event
            # only, so the other slots' decodes keep running underneath
            # the host work
            with trace_range("serving.retire.wait"):
                lg = slot.logits.wait()
            t_ready = time.monotonic()
            with trace_range("serving.retire.sample"):
                tok = lg.argmax(axis=-1).astype(np.int32)  # host-side sampling
            t = time.monotonic()
            with trace_range("serving.retire.account"):
                if not trace.retires:  # every row's first token
                    for r in slot.group:
                        r.first_token = t
                n_live = n_done = 0
                for j, r in enumerate(slot.group):
                    if not slot.live[j]:
                        continue
                    r.tokens.append(int(tok[j]))
                    slot.remaining[j] -= 1
                    n_live += 1
                    if slot.remaining[j] == 0:
                        slot.live[j] = False
                        n_done += 1
                        r.finished = t
                        r.output = np.asarray(r.tokens, np.int32)
                        self.done.append(r)
                self._record(t, n_live)
            t_accounted = time.monotonic()
            with trace_range("serving.retire.dispatch"):
                if n_live > n_done:
                    # the slot's logits were waited on above, so this
                    # decode (on the card, a replay of the entry's graph)
                    # may overwrite the entry's static logits buffer: the
                    # only reader it had was that copy
                    slot.cache, logits = self.engine.decode(slot.cache, tok[:, None])
                    slot.logits = self.engine.fetch_last(logits)
                else:
                    self.engine.release(slot.entry)
                    slot.group = slot.trace = slot.entry = None
                    slot.cache = slot.logits = None
            t_left = time.monotonic()
        trace.retires.append((t_enter, t_ready, t, t_accounted, t_left, n_live, n_live - n_done))

    def step_pass(self) -> bool:
        """One ring pass over this tenant's slots: refill idle slots from
        its pool, retire+redispatch active ones. Returns False when
        nothing could progress."""
        progressed = False
        active = [s for s in self.slots if s.group is not None]
        idle = [s for s in self.slots if s.group is None]
        self.slots = active + idle[: max(0, self.slot_budget - len(active))]
        while len(self.slots) < self.slot_budget:
            self.slots.append(_Slot())
        for slot in self.slots:
            if slot.group is None:
                group = self._form_group()
                if group:
                    self._start_group(slot, group)
                    progressed = True
                continue
            self._retire(slot)
            progressed = True
        return progressed

    # ----------------------------------------------------------- metrics
    def _record(self, t: float, n_tokens: int) -> None:
        self._tokens_total += n_tokens
        self._events.append((t, n_tokens))
        horizon = t - max(4.0 * self.rt.window_s, 10.0)
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def window_tokens(self, window_s: Optional[float] = None) -> int:
        w = window_s or self.rt.window_s
        now = time.monotonic()
        return sum(n for t, n in self._events if t >= now - w)

    def metrics_window(
        self, window_s: Optional[float] = None
    ) -> Dict[str, float]:
        """This tenant's rolling-window metrics: its own completions,
        queue and in-flight groups only — one tenant's burst never lands
        in a neighbour's record (tests/test_serving_runtime.py pins the
        isolation)."""
        w = window_s or self.rt.window_s
        now = time.monotonic()
        tokens = self.window_tokens(w)
        span = w if self.rt._t0 is None else min(w, now - self.rt._t0)
        reqs = [r for r in self.done if r.finished >= now - w]
        lat = [r.finished - self.rt._effective_arrival(r) for r in reqs] or [
            0.0
        ]
        return {
            "throughput_tok_s": tokens / max(span, 1e-9),
            "p50_latency_s": float(np.percentile(lat, 50)),
            "p99_latency_s": float(np.percentile(lat, 99)),
            "requests": len(reqs),
            "queue_depth": len(self.waiting),
            "in_flight": sum(s.group is not None for s in self.slots),
            "tau_floor": self.tau_floor,
            "interval_s": span,
        }


class ServingRuntime:
    def __init__(
        self,
        engine,
        batch_size: Optional[int] = None,
        concurrency: int = 1,
        window_s: float = 2.0,
    ):
        self.engine = engine
        self.window_s = window_s
        self._t0: Optional[float] = None
        self.rate_scale = 1.0
        # per-tenant decode rings over the shared pool, insertion-ordered;
        # the constructor's engine/batch/concurrency become the default
        # (single-tenant compatibility) ring
        self.tenants: Dict[str, _TenantRing] = {}
        self._default = self.add_tenant(
            DEFAULT_TENANT,
            engine=engine,
            batch_size=batch_size,
            slots=concurrency,
        )
        # ---- edge↔pod offload seam (attach_pod / set_offload) ----------
        self.pod_network = None  # repro_torch.device.network.NetworkProfile
        self.pod_time_per_token = 0.0
        self.pod_timeout_s = 30.0  # shipped-request deadline (attach_pod)
        self.pod_outage = False  # link down: responses lost until cleared
        self.offload_frac = 0.0
        self._route_acc = 0.0  # deterministic fractional-routing carry
        # (done_at, deadline, request, owning ring)
        self._pod_inflight: List[Tuple[float, float, Request, _TenantRing]] = []
        self.pod_tokens_total = 0
        self.pod_expired = 0  # shipped requests that hit the deadline
        self.network_energy_j = 0.0

    # ------------------------------------------------------------------
    # tenants
    # ------------------------------------------------------------------
    def add_tenant(
        self,
        name: str,
        engine=None,
        batch_size: Optional[int] = None,
        slots: int = 1,
        tau_floor: float = 0.0,
    ) -> _TenantRing:
        """Register a tenant ring. ``engine`` defaults to the runtime's
        (same model); pass a different engine to serve a second
        registry model on the same rail. ``slots`` is the ring's share of
        the decode-slot pool and ``tau_floor`` its τ SLO, both live knobs
        afterwards (``set_slot_allocation``)."""
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        ring = _TenantRing(
            name,
            self,
            engine if engine is not None else self.engine,
            batch_size=batch_size,
            slots=slots,
            tau_floor=tau_floor,
        )
        self.tenants[name] = ring
        self._reserve()
        return ring

    def _reserve(self) -> None:
        """Have each engine's cache pool hold every slot of the rings it
        serves (on the card, a captured graph each)."""
        need: Dict[int, int] = collections.Counter()
        for ring in self.tenants.values():
            need[id(ring.engine)] += ring.slot_budget
        for ring in self.tenants.values():
            ring.engine.reserve(need[id(ring.engine)])

    def ring(self, tenant: Optional[str] = None) -> _TenantRing:
        """The named tenant's ring (default ring when ``tenant`` is None)."""
        return self.tenants[DEFAULT_TENANT if tenant is None else tenant]

    def set_slot_allocation(self, alloc: Mapping[str, int]) -> None:
        """Live per-tenant slot knob: ``{tenant: slots}``. Growth adds
        idle slots on the ring's next pass; shrink lets excess groups
        finish and then drops their slots (no preemption) — the same
        semantics the single-tenant ``set_concurrency`` always had."""
        for name, c in alloc.items():
            self.tenants[name].slot_budget = max(1, int(c))
        self._reserve()

    # ------------------------------------------------------------------
    # single-tenant compatibility surface (delegates to the default ring)
    # ------------------------------------------------------------------
    @property
    def batch(self) -> int:
        return self._default.batch

    @property
    def concurrency(self) -> int:
        return self._default.slot_budget

    @concurrency.setter
    def concurrency(self, c: int) -> None:
        self.set_concurrency(c)

    @property
    def waiting(self) -> List[Request]:
        return self._default.waiting

    @property
    def done(self) -> List[Request]:
        return self._default.done

    @property
    def slots(self) -> List[_Slot]:
        return self._default.slots

    @property
    def prefills(self) -> int:
        return sum(r.prefills for r in self.tenants.values())

    def set_concurrency(self, c: int) -> None:
        """Live knob: target number of in-flight decode groups on the
        *default* ring (the single-tenant special case; multi-tenant
        callers use ``set_slot_allocation``)."""
        self._default.slot_budget = max(1, int(c))
        self._reserve()

    # ------------------------------------------------------------------
    # clock & admission
    # ------------------------------------------------------------------
    def start_clock(self) -> None:
        if self._t0 is None:
            self._t0 = time.monotonic()

    def now(self) -> float:
        """Seconds since the serving clock started (starts it on first use)."""
        self.start_clock()
        return time.monotonic() - self._t0

    def submit(self, req: Request, tenant: Optional[str] = None) -> None:
        ring = self.ring(tenant)
        req.tenant = ring.name
        ring.waiting.append(req)

    def set_rate_scale(self, scale: float) -> None:
        """DVFS emulation: pace the serving loop to ``scale``× its natural
        rate (the host cannot set the card's clocks, so reduced clocks are
        enacted as a pass-level pacing sleep — the queue then genuinely
        builds up under slow configs, which is what the closed-loop
        controller's latency/backlog signals feed on). One clock domain:
        the pace stretches every tenant's pass alike."""
        self.rate_scale = min(1.0, max(0.05, float(scale)))

    # ------------------------------------------------------------------
    # edge↔pod offload seam
    # ------------------------------------------------------------------
    def attach_pod(
        self,
        network,
        pod_time_per_token: float = 2e-3,
        timeout_s: float = 30.0,
    ) -> None:
        """Attach the uplink to the pod slice: ``network`` is a
        ``repro_torch.device.network.NetworkProfile`` and ``pod_time_per_token``
        the slice's per-token decode service time. Until ``set_offload``
        raises the route fraction above 0, everything still runs locally.
        ``timeout_s`` is the per-request response deadline: a shipped
        request whose reply has not landed by then is re-admitted to its
        owning ring and served locally (no silent leak).
        """
        self.pod_network = network
        self.pod_time_per_token = float(pod_time_per_token)
        self.pod_timeout_s = float(timeout_s)

    def set_pod_outage(self, active: bool) -> None:
        """Live fault knob: while the link is down, no new request ships
        (admissions run locally) and responses stop arriving — in-flight
        shipped requests sit until their deadline and are then re-admitted
        to the edge. Clearing the outage before a request's deadline lets
        its response land normally."""
        self.pod_outage = bool(active)

    def set_offload(self, frac: float) -> None:
        """Live placement knob: the fraction of *admitted* requests routed
        to the pod. Routing is decided once per request at admission by a
        deterministic fractional accumulator (no RNG: every 1/frac-th
        admissible request ships), so two runs with the same trace and
        knob settings route identically."""
        self.offload_frac = min(1.0, max(0.0, float(frac)))

    def _ship_to_pod(self, r: Request, t: float, ring: _TenantRing) -> None:
        """Ship one request over the attached uplink. End-to-end latency
        is network + remote service: upload serialization + one RTT + the
        pod slice's per-token decode time. The radio energy meter charges
        per shipped token (prompt up, generated tokens down) — the only
        place pod-routed work ever touches the edge power rail. The local
        engine is never invoked for shipped requests."""
        net = self.pod_network
        n_tok = int(r.prompt.size) + int(r.max_new_tokens)
        upload_s = int(r.prompt.size) * net.token_bytes / net.bandwidth
        done_at = (
            t
            + upload_s
            + net.rtt_s
            + int(r.max_new_tokens) * self.pod_time_per_token
        )
        self.network_energy_j += n_tok * net.ship_energy_per_token_j
        self.pod_tokens_total += int(r.max_new_tokens)
        r.started = t
        deadline = t + max(self.pod_timeout_s, done_at - t)
        self._pod_inflight.append((done_at, deadline, r, ring))

    def _route_admissible(self, t: float) -> bool:
        """Admission-time placement: walk every ring's pool once, decide
        edge vs pod for each newly-admissible request, and ship the
        pod-routed ones. Requests stay route="edge" forever once
        committed — the accumulator only advances on first admission, so
        later knob changes affect later arrivals only. One accumulator
        across tenants: the route fraction is a property of the shared
        uplink, not of any one ring."""
        if self.pod_network is None or self.pod_outage:
            # link absent or down: requests stay route=None and the rings
            # serve them locally; the accumulator holds so the route
            # fraction resumes cleanly when the link returns
            return False
        now = self.now()
        progressed = False
        for ring in self.tenants.values():
            shipped: List[Request] = []
            for r in ring.waiting:
                if r.route is not None:
                    continue
                if r.arrival_s is not None and r.arrival_s > now:
                    continue
                self._route_acc += self.offload_frac
                if self._route_acc >= 1.0 - 1e-12:
                    self._route_acc -= 1.0
                    r.route = "pod"
                    shipped.append(r)
                else:
                    r.route = "edge"
            if not shipped:
                continue
            ids = {id(r) for r in shipped}
            ring.waiting = [r for r in ring.waiting if id(r) not in ids]
            for r in shipped:
                self._ship_to_pod(r, t, ring)
            progressed = True
        return progressed

    def _poll_pod(self, t: float) -> bool:
        """Retire pod-routed requests whose (network + remote service)
        completion time has passed, and expire the ones whose deadline
        has. Completion is token-accounted like a local retire — on the
        owning tenant's ring — so windowed throughput/latency metrics see
        pod traffic, including its network latency, on equal terms.
        Expired requests (deadline passed with no response — a dead link
        or a stalled pod) are re-admitted to their owning ring pinned to
        the edge route, so nothing the runtime accepted is ever leaked."""
        if not self._pod_inflight:
            return False
        keep: List[Tuple[float, float, Request, _TenantRing]] = []
        due: List[Tuple[float, float, Request, _TenantRing]] = []
        expired: List[Tuple[float, float, Request, _TenantRing]] = []
        for e in self._pod_inflight:
            if not self.pod_outage and e[0] <= t:
                due.append(e)
            elif e[1] <= t:
                expired.append(e)
            else:
                keep.append(e)
        if not due and not expired:
            return False
        self._pod_inflight = keep
        for done_at, _, r, ring in sorted(due, key=lambda e: e[0]):
            r.finished = done_at
            r.tokens = [0] * int(r.max_new_tokens)
            r.output = np.zeros(int(r.max_new_tokens), np.int32)
            ring.done.append(r)
            ring._record(done_at, int(r.max_new_tokens))
        for _, _, r, ring in expired:
            # pin to the edge so the retry cannot bounce back to a dead
            # link — the local ring serves it on its next pass
            r.route = "edge"
            r.tokens = []
            self.pod_expired += 1
            ring.waiting.append(r)
        return True

    # ------------------------------------------------------------------
    # the shared pass
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One pass over every tenant's ring: route/poll the pod seam,
        then each ring refills idle slots from its own pool and
        retires+redispatches active ones. Returns False when nothing
        could progress (all rings idle and no admissible request).
        Pacing is applied once, to the whole pass — shared DVFS means
        one clock domain for every tenant."""
        self.start_clock()
        t_pass = time.monotonic()
        progressed = self._route_admissible(t_pass)
        progressed |= self._poll_pod(t_pass)
        for ring in self.tenants.values():
            progressed |= ring.step_pass()
        if progressed and self.rate_scale < 1.0:
            # stretch the pass to 1/scale of its natural duration
            time.sleep((1.0 / self.rate_scale - 1.0) * (time.monotonic() - t_pass))
        return progressed

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def _effective_arrival(self, r: Request) -> float:
        if r.arrival_s is not None and self._t0 is not None:
            return self._t0 + r.arrival_s
        return r.arrived

    def _metrics(
        self, reqs: List[Request], tokens: int, span: float
    ) -> Dict[str, float]:
        lat = [r.finished - self._effective_arrival(r) for r in reqs] or [0.0]
        return {
            "throughput_tok_s": tokens / max(span, 1e-9),
            "p50_latency_s": float(np.percentile(lat, 50)),
            "p99_latency_s": float(np.percentile(lat, 99)),
            "requests": len(reqs),
            "queue_depth": sum(
                len(ring.waiting) for ring in self.tenants.values()
            ),
            "in_flight": sum(
                sum(s.group is not None for s in ring.slots)
                for ring in self.tenants.values()
            ),
            "pod_inflight": len(self._pod_inflight),
            "pod_expired": self.pod_expired,
            "network_energy_j": self.network_energy_j,
            "interval_s": span,
        }

    def metrics_window(self, window_s: Optional[float] = None) -> Dict[str, float]:
        """Aggregate rolling-window metrics over the last ``window_s``
        seconds, across every tenant (the shared-rail view the
        single-tenant controller observes)."""
        w = window_s or self.window_s
        now = time.monotonic()
        tokens = sum(r.window_tokens(w) for r in self.tenants.values())
        span = w if self._t0 is None else min(w, now - self._t0)
        reqs = [
            r
            for ring in self.tenants.values()
            for r in ring.done
            if r.finished >= now - w
        ]
        return self._metrics(reqs, tokens, span)

    def tenant_metrics(
        self, window_s: Optional[float] = None
    ) -> Dict[str, Dict[str, float]]:
        """Per-tenant rolling-window metrics: ``{tenant: metrics}`` —
        the split the multi-tenant controller scores against per-tenant
        τ floors (``core.coral.joint_headroom``)."""
        return {
            name: ring.metrics_window(window_s)
            for name, ring in self.tenants.items()
        }

    def attribute_power(
        self, total_w: float, window_s: Optional[float] = None
    ) -> Dict[str, float]:
        """Split a shared-rail power reading across tenants in proportion
        to their windowed token throughput (equal split when the window
        is empty). The attributions sum *exactly* to ``total_w`` — the
        rail is one meter, attribution is accounting, and a lossy split
        would let per-tenant ledgers disagree with the rail."""
        names = list(self.tenants)
        weights = np.asarray(
            [self.tenants[n].window_tokens(window_s) for n in names],
            np.float64,
        )
        if weights.sum() <= 0:
            weights = np.ones(len(names))
        shares = total_w * weights / weights.sum()
        # pin the float ledger: the last tenant absorbs rounding residue
        shares[-1] = total_w - float(shares[:-1].sum())
        return {n: float(s) for n, s in zip(names, shares)}

    # ------------------------------------------------------------------
    # serving loops
    # ------------------------------------------------------------------
    def _busy(self) -> bool:
        return any(
            ring.waiting
            or any(s.group is not None for s in ring.slots)
            for ring in self.tenants.values()
        )

    def run_for(self, seconds: float, idle_wait: bool = False) -> Dict[str, float]:
        """Serve one control interval; returns aggregate metrics for what
        completed inside it (``tenant_metrics`` for the per-ring split).
        With ``idle_wait`` the runtime sits out traffic gaps (closed-loop
        control under a trace); without it, an empty pool ends the
        interval early (metrics use the actual elapsed span)."""
        self.start_clock()
        t0 = time.monotonic()
        tok0 = {n: r._tokens_total for n, r in self.tenants.items()}
        done0 = {n: len(r.done) for n, r in self.tenants.items()}
        while time.monotonic() - t0 < seconds:
            if not self.step():
                if not idle_wait and not self._busy() and not self._pod_inflight:
                    break
                with trace_range("serving.idle"):
                    time.sleep(5e-4)
        span = time.monotonic() - t0
        new = [
            r
            for n, ring in self.tenants.items()
            for r in ring.done[done0[n]:]
        ]
        tokens = sum(
            r._tokens_total - tok0[n] for n, r in self.tenants.items()
        )
        return self._metrics(new, tokens, span)

    def drain(self, timeout_s: float = 300.0) -> Dict[str, float]:
        """Serve until every submitted request — every tenant's —
        completes (or ``timeout_s`` elapses; a leftover ``queue_depth``
        marks an incomplete drain); aggregate metrics (the old
        ``Scheduler.run`` contract)."""
        self.start_clock()
        t0 = time.monotonic()
        tok0 = {n: r._tokens_total for n, r in self.tenants.items()}
        done0 = {n: len(r.done) for n, r in self.tenants.items()}
        while self._busy() or self._pod_inflight:
            if time.monotonic() - t0 > timeout_s:
                break
            if not self.step():
                time.sleep(5e-4)
        span = time.monotonic() - t0
        new = [
            r
            for n, ring in self.tenants.items()
            for r in ring.done[done0[n]:]
        ]
        tokens = sum(
            r._tokens_total - tok0[n] for n, r in self.tenants.items()
        )
        return self._metrics(new, tokens, span)


def measure_runtime_throughput(
    engine,
    concurrency: int,
    prompt_len: int = 16,
    new_tokens: int = 16,
    groups: int = 4,
    batch_size: Optional[int] = None,
    vocab: int = 512,
    seed: int = 0,
    warmup: bool = True,
) -> float:
    """Measured decode tokens/sec of the runtime at a given concurrency.

    Serves a fixed saturating workload (``groups`` full batches submitted
    up front, no arrival gaps) and reports drain throughput — the probe
    behind ``WalltimeDevice`` and the τ-vs-concurrency benchmark. Pass the
    same ``groups`` (≥ the largest concurrency to be compared, ideally 2×)
    at every concurrency level so the knob is the only variable."""
    rng = np.random.default_rng(seed)
    if warmup:
        # run prefill/decode for this (batch, prompt_len) once outside the
        # timed drain — first-call costs (library loads, allocator growth)
        # would otherwise understate the first probed level and can invert
        # the c→τ signal
        wrt = ServingRuntime(engine, batch_size=batch_size, concurrency=1)
        for rid in range(wrt.batch):
            wrt.submit(
                Request(
                    -1 - rid, rng.integers(0, vocab, prompt_len, dtype=np.int32), 2
                )
            )
        wrt.drain()
    runtime = ServingRuntime(engine, batch_size=batch_size, concurrency=concurrency)
    for rid in range(groups * runtime.batch):
        runtime.submit(
            Request(
                rid,
                rng.integers(0, vocab, prompt_len, dtype=np.int32),
                new_tokens,
            )
        )
    return runtime.drain()["throughput_tok_s"]


def measure_concurrency_curve(
    engine,
    c_values,
    rounds: int = 4,
    min_rounds: int = 2,
    gain_gate: float = 1.2,
    prompt_len: int = 8,
    new_tokens: int = 16,
    groups: int = 10,
    batch_size: Optional[int] = None,
    vocab: int = 512,
    seed: int = 0,
) -> Tuple[Dict[int, float], int]:
    """Best-of interleaved τ-vs-concurrency sweep over ``c_values``
    (ascending, starting at the baseline level, normally 1).

    One shared protocol for the benchmark, the example and the
    sensitivity test: on shared hosts neighbour interference only ever
    slows a run down, so the per-level running max converges to the
    level's capability, and rounds are interleaved so drift hits every
    level equally. Stops early (after ``min_rounds``) once the knee is
    visible — the second level above the first and some c past
    ``gain_gate``× the baseline. Returns ({c: best tok/s}, rounds used).
    """
    c_values = [int(c) for c in c_values]
    best = {c: 0.0 for c in c_values}
    used = 0
    warm = True
    for used in range(1, max(rounds, min_rounds) + 1):
        for c in c_values:
            best[c] = max(
                best[c],
                measure_runtime_throughput(
                    engine,
                    c,
                    prompt_len=prompt_len,
                    new_tokens=new_tokens,
                    groups=groups,
                    batch_size=batch_size,
                    vocab=vocab,
                    seed=seed,
                    warmup=warm,
                ),
            )
            warm = False  # first-call costs paid by the first probe's warmup
        base = best[c_values[0]]
        if (
            used >= min_rounds
            and len(c_values) > 1
            and best[c_values[1]] > base
            and max(best[c] for c in c_values[1:]) >= gain_gate * base
        ):
            break
    return best, used
