"""The runtime's edge↔pod seam against the JAX package's: the
counterparts of ``tests/test_offload.py``'s serving-seam tests and of
``tests/test_faults.py``'s pod-outage tests, each run through both
runtimes over engine doubles, which route the same requests to the pod
(the split is a deterministic accumulator, no RNG). Energy is compared
at rel 1e-12 (the same float64 sums); no wall-clock ratio is asserted.
"""
import numpy as np
import pytest

from repro.device.network import get_network as jax_get_network
from repro.serving.runtime import Request as JaxRequest
from repro.serving.runtime import ServingRuntime as JaxRuntime
from repro_torch.device.network import get_network
from repro_torch.serving.engine import HostLogits
from repro_torch.serving.runtime import Request, ServingRuntime


class _CountingEngine:
    """Engine double: counts entries so a test can prove where a request
    was served. The port's runtime also asks it to reserve and hand out
    pool entries and for the logits' way to the host, which the
    reference's does not."""

    batch = 4

    def __init__(self):
        self.prefill_calls = 0
        self.decode_calls = 0
        self.entries = 0

    def reserve(self, n):
        pass

    def acquire(self):
        self.entries += 1
        return 0

    def release(self, entry):
        self.entries -= 1

    def prefill(self, prompts, entry=None):
        self.prefill_calls += 1
        return {}, np.zeros((prompts.shape[0], prompts.shape[1], 8))

    def decode(self, cache, tok):
        self.decode_calls += 1
        return cache, np.zeros((tok.shape[0], 1, 8))

    @staticmethod
    def fetch_last(logits):
        import torch

        return HostLogits(torch.from_numpy(np.asarray(logits, np.float32)))


class _JaxCountingEngine(_CountingEngine):
    def prefill(self, prompts):
        return super().prefill(prompts)


PACKAGES = {
    "port": (ServingRuntime, Request, get_network, _CountingEngine),
    "jax": (JaxRuntime, JaxRequest, jax_get_network, _JaxCountingEngine),
}


def _run_split(pkg, frac, n=8, max_new=4, prompt_len=8):
    runtime, request, network, engine = PACKAGES[pkg]
    net = network("lte-uplink")
    eng = engine()
    rt = runtime(eng, concurrency=2)
    rt.attach_pod(net, pod_time_per_token=1e-3)
    rt.set_offload(frac)
    rng = np.random.default_rng(0)
    for i in range(n):
        rt.submit(request(i, rng.integers(0, 99, prompt_len, dtype=np.int32), max_new,
                          arrival_s=0.0))
    rt.drain()
    return net, eng, rt


def _routes(rt):
    return sorted((r.rid, r.route) for r in rt.done)


@pytest.mark.parametrize("frac", [0.0, 0.25, 0.5, 1.0])
def test_routes_equal_the_reference(frac):
    _, eng, rt = _run_split("port", frac)
    _, jeng, jrt = _run_split("jax", frac)
    assert _routes(rt) == _routes(jrt)
    assert (rt.pod_tokens_total, eng.prefill_calls) == (jrt.pod_tokens_total, jeng.prefill_calls)
    assert rt.network_energy_j == pytest.approx(jrt.network_energy_j, rel=1e-12)
    assert eng.entries == 0  # every pool entry a group took was given back


def test_pod_routed_requests_never_enter_engine():
    net, eng, rt = _run_split("port", 1.0)
    assert len(rt.done) == 8
    assert all(r.route == "pod" for r in rt.done)
    assert eng.prefill_calls == 0 and eng.decode_calls == 0
    assert rt.prefills == 0  # the edge compute rail stayed dark


def test_deterministic_fractional_routing():
    net, eng, rt = _run_split("port", 0.5)
    pod = [r for r in rt.done if r.route == "pod"]
    edge = [r for r in rt.done if r.route == "edge"]
    assert len(pod) == 4 and len(edge) == 4
    assert eng.prefill_calls > 0  # the edge share ran locally
    _, _, rt2 = _run_split("port", 0.5)
    assert _routes(rt2) == _routes(rt)


def test_network_energy_metered_per_shipped_token():
    net, eng, rt = _run_split("port", 0.5, n=8, max_new=4, prompt_len=8)
    pod = [r for r in rt.done if r.route == "pod"]
    expect = sum((r.prompt.size + r.max_new_tokens) * net.ship_energy_per_token_j for r in pod)
    assert rt.network_energy_j == pytest.approx(expect, rel=1e-12)
    _, _, rt0 = _run_split("port", 0.0)
    assert rt0.network_energy_j == 0.0


def test_pod_latency_includes_network():
    net, eng, rt = _run_split("port", 0.5, prompt_len=8, max_new=4)
    pod = [r for r in rt.done if r.route == "pod"]
    assert pod
    for r in pod:
        lat = r.finished - rt._effective_arrival(r)
        floor = (r.prompt.size * net.token_bytes / net.bandwidth + net.rtt_s
                 + r.max_new_tokens * 1e-3)
        assert lat >= floor - 1e-9


def test_offload_knob_requires_network():
    from repro_torch.device import get_profile
    from repro_torch.experiments import MATRIX_OFFLOAD_CELLS, offload_cell_simulator
    from repro_torch.serving.controller import ServingController

    prof = get_profile("edge-xavier-nx")
    space = offload_cell_simulator(MATRIX_OFFLOAD_CELLS[0], noise=0.0).space
    rt = ServingRuntime(_CountingEngine(), concurrency=2)
    with pytest.raises(ValueError, match="offload_frac"):
        ServingController(rt, space, [], tau_target=1.0, profile=prof, device="cpu")


def _pod_runtime(pkg, timeout_s):
    runtime, request, network, engine = PACKAGES[pkg]
    eng = engine()
    rt = runtime(eng, concurrency=2)
    rt.attach_pod(network("lte-uplink"), pod_time_per_token=1e-3, timeout_s=timeout_s)
    rt.set_offload(1.0)
    rng = np.random.default_rng(0)
    for i in range(4):
        rt.submit(request(i, rng.integers(0, 99, 8, dtype=np.int32), 2, arrival_s=0.0))
    return eng, rt


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pod_outage_expires_shipped_requests_back_to_edge(pkg):
    eng, rt = _pod_runtime(pkg, timeout_s=0.05)
    rt.step()  # ship everything while the link is still up
    assert len(rt._pod_inflight) == 4
    rt.set_pod_outage(True)  # responses lost until cleared
    rt.run_for(0.5, idle_wait=True)
    rt.set_pod_outage(False)
    rt.drain()
    assert rt.pod_expired == 4
    assert len(rt.done) == 4
    assert all(r.route == "edge" for r in rt.done)
    assert eng.prefill_calls > 0
    assert [len(r.tokens) for r in rt.done] == [2] * 4


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pod_outage_cleared_before_deadline_loses_nothing(pkg):
    eng, rt = _pod_runtime(pkg, timeout_s=30.0)
    rt.step()
    rt.set_pod_outage(True)
    rt.run_for(0.1, idle_wait=True)
    assert len(rt.done) == 0  # responses held while the link is down
    rt.set_pod_outage(False)
    rt.drain()
    assert rt.pod_expired == 0
    assert len(rt.done) == 4
    assert all(r.route == "pod" for r in rt.done)
    assert eng.prefill_calls == 0


def test_metrics_carry_the_pod_counters():
    _, _, rt = _run_split("port", 0.5)
    m = rt.metrics_window(60.0)
    assert m["pod_inflight"] == 0 and m["pod_expired"] == 0
    assert m["network_energy_j"] == rt.network_energy_j > 0
