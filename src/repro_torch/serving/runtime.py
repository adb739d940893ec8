"""Continuous-batching serving runtime — per-tenant decode rings over a
shared slot pool (the counterpart of ``repro/serving/runtime.py``).

Port notes. (1) Retire waits on its own slot only: at dispatch the
engine starts a non-blocking copy of the last position's logits into
pinned host memory behind a CUDA event (``ServingEngine.fetch_last``),
and retire waits on that event, where the reference relies on a JAX
device→host transfer skipping the execute queue. (2) The edge↔pod
offload seam (``attach_pod``, ``set_pod_outage``, ``set_offload``,
``_ship_to_pod``, ``_poll_pod``) waits for the offload slice (ROADMAP
queue 1 item 14); every request is served locally.

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
    # owning tenant ring, stamped at submit
    tenant: Optional[str] = None


class _Slot:
    """One in-flight decode group: KV cache + outstanding logits future."""

    __slots__ = ("group", "cache", "logits", "live", "remaining")

    def __init__(self):
        self.group: Optional[List[Request]] = None
        self.cache = None
        self.logits = None  # HostLogits: the outstanding logits' copy to the host
        self.live: List[bool] = []
        self.remaining: List[int] = []


class _TenantRing:
    """One tenant: admission queue, decode slots, windowed metrics.

    The ring owns everything per-tenant — its engine (model), batch
    shape, slot budget, τ-floor, pools and token/event accounting — and
    borrows the shared pieces (clock, pacing) from the owning
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
        self.steps = 0
        self.prefills = 0

    # -------------------------------------------------------------- pool
    def _form_group(self) -> Optional[List[Request]]:
        """FIFO group of admissible requests sharing the head's prompt
        length — equal-length grouping, never pad/clip to another
        request's shape."""
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
        ids = {id(r) for r in picked}
        self.waiting = [r for r in self.waiting if id(r) not in ids]
        return picked

    # ---------------------------------------------------------- pipeline
    def _start_group(self, slot: _Slot, group: List[Request]) -> None:
        prompts = np.stack([r.prompt for r in group])
        if len(group) < self.batch:
            prompts = np.pad(prompts, ((0, self.batch - len(group)), (0, 0)))
        t = time.monotonic()
        for r in group:
            r.started = t
        # async dispatch: the prefill (and its first logits) queue behind
        # whatever the other slots — every tenant's — already have in
        # flight. The last position's copy to the host starts here, not at
        # retire: retire must only ever wait for this slot's own copy — a
        # read there would queue behind every other slot's in-flight
        # decode and serialize the whole ring.
        slot.cache, logits = self.engine.prefill(prompts)
        slot.logits = self.engine.fetch_last(logits)
        slot.group = group
        slot.live = [True] * len(group)
        slot.remaining = [max(1, int(r.max_new_tokens)) for r in group]
        self.prefills += 1

    def _retire(self, slot: _Slot) -> None:
        """Host stage: block on this slot's logits, sample greedily on the
        host, account tokens/completions, then dispatch the next decode."""
        # (B, vocab) float32 logits: waits on *this slot's* copy event
        # only, so the other slots' decodes keep running underneath the
        # host work
        lg = slot.logits.wait()
        tok = lg.argmax(axis=-1).astype(np.int32)  # host-side sampling
        t = time.monotonic()
        n_live = 0
        for j, r in enumerate(slot.group):
            if not slot.live[j]:
                continue
            r.tokens.append(int(tok[j]))
            slot.remaining[j] -= 1
            n_live += 1
            if slot.remaining[j] == 0:
                slot.live[j] = False
                r.finished = t
                r.output = np.asarray(r.tokens, np.int32)
                self.done.append(r)
        self._record(t, n_live)
        self.steps += 1
        if any(slot.live):
            slot.cache, logits = self.engine.decode(slot.cache, tok[:, None])
            slot.logits = self.engine.fetch_last(logits)
        else:
            slot.group = None
            slot.cache = slot.logits = None

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
        return ring

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
        self._default.slot_budget = max(1, int(c))

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
    def steps(self) -> int:
        return sum(r.steps for r in self.tenants.values())

    @property
    def prefills(self) -> int:
        return sum(r.prefills for r in self.tenants.values())

    def set_concurrency(self, c: int) -> None:
        """Live knob: target number of in-flight decode groups on the
        *default* ring (the single-tenant special case; multi-tenant
        callers use ``set_slot_allocation``)."""
        self._default.slot_budget = max(1, int(c))

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
    # the shared pass
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One pass over every tenant's ring: each ring refills idle slots
        from its own pool and retires+redispatches active ones. Returns False when nothing
        could progress (all rings idle and no admissible request).
        Pacing is applied once, to the whole pass — shared DVFS means
        one clock domain for every tenant."""
        self.start_clock()
        t_pass = time.monotonic()
        progressed = False
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
                if not idle_wait and not self._busy():
                    break
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
        while self._busy():
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
