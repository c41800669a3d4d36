"""The port's trace module (zkfl_tpu_torch/trace.py) and the readers of
zkfl_tpu_torch/scripts/trace_round.py, on the CPU: nothing recorded or
timed while off, nesting and threads while on, the same proof traced and
untraced, run_round's timings, and the readers on hand-built spans and a
synthetic profiler record."""

import collections
import json
import threading

import pytest
import torch

from zkfl_tpu_torch import trace
from zkfl_tpu_torch.field.bn254 import FR
from zkfl_tpu_torch.scripts import trace_round as tr
from zkfl_tpu_torch.trace import Span

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)  # a device name only: nothing runs on it here


@pytest.fixture(autouse=True)
def clean_trace():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read while tracing is off")

    monkeypatch.setattr(trace, "clock_ns", no_clock)
    monkeypatch.setattr(trace, "_Open", None)  # constructing a record would raise
    assert trace.span("a.b") is trace.OFF
    assert trace.sync(CUDA, h2d=64) is trace.OFF
    with trace.span("a.b"), trace.sync(CUDA):
        trace.count("a.c", 5)
    assert trace.spanned("a.d")(lambda x: x + 1)(1) == 2
    assert trace.take() == ([], collections.Counter())


def test_nesting_parents_roots_and_take():
    trace.enable()
    with trace.span("r.a"):
        with trace.span("r.b"):
            with trace.span("r.c"):
                trace.count("r.n", 2)
        with trace.span("r.d"):
            trace.count("r.n")
    with trace.span("r.e"):
        pass
    spans, counters = trace.take()
    assert [s.name for s in spans] == ["r.a", "r.b", "r.c", "r.d", "r.e"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    assert [s.root for s in spans] == [0, 0, 0, 0, 4]
    assert all(0 < s.start_ns <= s.end_ns for s in spans)
    assert spans[1].start_ns >= spans[0].start_ns and spans[1].end_ns <= spans[0].end_ns
    assert counters == {"r.n": 3}
    assert trace.take() == ([], collections.Counter())


def test_take_inside_an_open_span_raises():
    trace.enable()
    with trace.span("r.a"):
        with pytest.raises(RuntimeError):
            trace.take()


def test_each_thread_keeps_its_own_stack():
    trace.enable()
    opened, go_on = threading.Barrier(2), threading.Barrier(2)

    def worker(tag):
        with trace.span(f"t.{tag}"):
            opened.wait()  # both outer spans open at once
            with trace.span(f"t.{tag}.inner"):
                go_on.wait()

    threads = [threading.Thread(target=worker, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans, _ = trace.take()
    index = {s.name: i for i, s in enumerate(spans)}
    for tag in "xy":
        inner = spans[index[f"t.{tag}.inner"]]
        assert inner.parent == index[f"t.{tag}"] and inner.root == index[f"t.{tag}"]
        assert spans[index[f"t.{tag}"]].parent == -1


def test_self_time_and_ancestry():
    spans = [Span("a", 0, 100, -1, 0), Span("b", 10, 40, 0, 0), Span("c", 15, 25, 1, 0),
             Span("d", 50, 70, 0, 0), Span("e", 120, 130, -1, 4)]
    assert trace.self_ns(spans) == [50, 20, 10, 20, 10]
    assert trace.under(spans, 2, {"a"}) and trace.under(spans, 2, {"b"})
    assert not trace.under(spans, 2, {"c"}) and not trace.under(spans, 4, {"a"})
    assert trace.seconds(spans, "b") == 30e-9


def test_sync_counts_cuda_waits_and_copied_bytes():
    trace.enable()
    with trace.sync(CPU, h2d=8):
        pass
    with trace.sync(CUDA, h2d=32), trace.sync(CUDA, d2h=16, waits=2):
        pass
    spans, counters = trace.take()
    assert [s.name for s in spans] == ["device.sync", "device.sync"]
    assert counters == {"device.syncs": 3, "pipeline.h2d_bytes": 32, "pipeline.d2h_bytes": 16}


def test_timed_fills_the_key_on_and_off():
    out = {}
    with trace.timed(out, "off", "t.off"):
        pass
    trace.enable()
    with trace.timed(out, "on", "t.on"):
        pass
    spans, _ = trace.take()
    assert set(out) == {"off", "on"} and min(out.values()) >= 0
    assert [s.name for s in spans] == ["t.on"]


def _toy():
    from zkfl_tpu_torch.groth16.setup import groth16_setup
    from zkfl_tpu_torch.r1cs.builder import ConstraintSystem

    cs = ConstraintSystem(name="toy")
    x, y = 3, 5
    out = cs.public_input("out", (x * x % FR * y + x + 7) % FR)
    xin, yin = cs.private_input("x", x), cs.private_input("y", y)
    cs.enforce_equal(cs.mul(cs.mul(xin, xin), yin) + xin + 7, out)
    pk, vk = groth16_setup(cs, seed="toy-seed", device=None)
    return cs, pk, vk


def test_groth16_prove_traced_equals_untraced_and_nests():
    """Deterministic blinding (tests/conftest.py): the same proof with
    tracing on and off, and the pipeline, MSM and assembly spans nested
    under the prove."""
    from zkfl_tpu_torch.groth16.engine import TorchEngine
    from zkfl_tpu_torch.groth16.prover import groth16_prove
    from zkfl_tpu_torch.groth16.verifier import groth16_verify

    cs, pk, vk = _toy()
    engine = TorchEngine(CPU)
    off = groth16_prove(pk, cs, engine=engine)
    trace.enable()
    on = groth16_prove(pk, cs, engine=engine)
    assert groth16_verify(vk, on)
    spans, counters = trace.take()
    assert (on.pi_a, on.pi_b, on.pi_c, on.public_signals) == \
        (off.pi_a, off.pi_b, off.pi_c, off.public_signals)

    names = [s.name for s in spans]
    prove = names.index("groth16.prove")
    assert spans[prove].parent == -1
    for stage in ("pipeline.pack", "pipeline.upload", "pipeline.to_mont", "pipeline.qap",
                  "pipeline.scalars", "pipeline.decode", "msm.digits", "msm.sort", "msm.scan",
                  "msm.buckets", "msm.fold", "msm.horner", "groth16.assemble"):
        assert stage in names, stage
        assert all(s.parent == prove for s in spans if s.name == stage), stage
    assert names.count("msm.horner") == 2  # one G1 and one G2 MSM
    assemble = names.index("groth16.assemble")
    muls = [s for s in spans if s.name == "groth16.scalar_mul"]
    assert muls and muls[0].parent == assemble
    assert {names[s.parent] for s in muls} == {"groth16.assemble", "groth16.vk_x"}
    verify = names.index("groth16.verify")
    assert [s.name for s in spans if s.parent == verify] == ["groth16.vk_x", "groth16.pairing"]
    assert not counters["device.syncs"]  # nothing waits on the CPU


class _StubProver:
    """A round without proofs: each 'proof' carries its witness's public
    signals and verifies."""

    can_batch = False

    def __init__(self, cfg):
        from zkfl_tpu_torch.r1cs.circuits import dummy_inputs, generate_witness

        self.n_pub = {name: generate_witness(p, dummy_inputs(p)).n_pub for name, p in (
            ("balance", cfg.balance_params), ("training", cfg.training_params),
            ("secagg", cfg.secagg_params))}

    def _proof(self, name, witness):
        from zkfl_tpu_torch.groth16.prover import Proof

        return Proof(None, None, None, list(witness[1:1 + self.n_pub[name]]))

    def prove_balance(self, w):
        return self._proof("balance", w)

    def prove_training(self, w):
        return self._proof("training", w)

    def prove_secagg(self, w):
        return self._proof("secagg", w)

    def verify_balance(self, proof):
        return True

    verify_training = verify_secagg = verify_balance


PHASES = ["setup", "datasets", "commitments", "balance_proofs", "training_proofs",
          "secagg_proofs", "aggregate", "total"]


@pytest.mark.parametrize("traced", [False, True])
def test_run_round_timings_keep_their_keys(traced, monkeypatch):
    from zkfl_tpu_torch.fl.config import MICRO_CONFIG
    from zkfl_tpu_torch.fl.simulation import run_round

    prover = _StubProver(MICRO_CONFIG)
    if traced:
        trace.enable()
    else:
        monkeypatch.setattr(trace, "_Open", None)  # an untraced round makes no record
    server, timings = run_round(MICRO_CONFIG, prover=prover, verbose=False)
    assert server.get_summary()["all_passed"]
    assert list(timings) == PHASES and all(v >= 0 for v in timings.values())
    assert timings["total"] >= sum(timings[k] for k in PHASES[:-1])
    spans, counters = trace.take()
    if not traced:
        assert spans == [] and not counters
        return
    assert spans[0].name == "fl.round" and spans[0].parent == -1
    assert [s.name for s in spans if s.parent == 0] == [f"fl.{k}" for k in PHASES[:-1]]
    assert all(s.root == 0 for s in spans)
    names = collections.Counter(s.name for s in spans)
    assert names["r1cs.poseidon"] == counters["r1cs.poseidon"] > 0
    assert names["commit.tree"] == MICRO_CONFIG.num_clients
    assert names["r1cs.witness"] >= 3 * MICRO_CONFIG.num_clients


# -- the readers of scripts/trace_round.py -------------------------------------


def _hand_built():
    """Two proofs' worth of spans: a witness with two hashes, an assembly
    and a verify with scalar muls, pipeline stages with a wait inside."""
    return [
        Span("r1cs.witness", 0, 100, -1, 0),
        Span("r1cs.poseidon", 10, 40, 0, 0),
        Span("r1cs.poseidon", 50, 70, 0, 0),
        Span("r1cs.poseidon", 200, 260, -1, 3),          # not under a witness
        Span("groth16.prove", 300, 1300, -1, 4),
        Span("pipeline.upload", 310, 400, 4, 4),
        Span("device.sync", 320, 390, 5, 4),
        Span("pipeline.qap", 400, 600, 4, 4),
        Span("groth16.assemble", 1000, 1200, 4, 4),
        Span("groth16.scalar_mul", 1010, 1110, 8, 4),
        Span("groth16.verify", 1400, 1600, -1, 10),
        Span("groth16.scalar_mul", 1410, 1460, 10, 10),
        Span("groth16.scalar_mul", 1700, 1800, -1, 12),  # a setup's, not counted
        Span("device.sync", 1900, 2000, -1, 13),         # outside the pipeline
    ]


def test_host_metrics_on_hand_built_spans():
    spans = _hand_built()
    m = tr.host_metrics(spans, collections.Counter({"device.syncs": 6}), proofs=2, rounds=3)
    assert m["witness_hash_share"] == pytest.approx(50.0)
    assert m["host_scalar_mul_ms"] == pytest.approx(150 / 2 / 1e6)
    assert m["pipeline_host_ms"] == pytest.approx((90 + 200 - 70) / 2 / 1e6)
    assert m["syncs_per_round"] == 2.0
    unsynced = tr.host_metrics(spans, collections.Counter(), proofs=2, rounds=3)
    assert unsynced["syncs_per_round"] == 0.0
    empty = tr.host_metrics([], collections.Counter(), proofs=0, rounds=0)
    assert all(v is None for v in empty.values())
    assert tr.totals(spans)["groth16.prove"] == pytest.approx([1000e-9, 510e-9, 1])


class _Event:
    def __init__(self, name, device, start_ns, dur_ns, corr):
        self._v = (name, device, start_ns, dur_ns, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


def test_device_record_and_attribution_by_correlation_id():
    """Host spans (ns on the host clock) and a synthetic profiler record
    whose clock runs 1 s ahead: each kernel is charged to the span open at
    its runtime call, not at its own start on the card."""
    S = 1_000_000_000
    spans = [
        Span("groth16.prove", 0, 1000, -1, 0),
        Span("msm.scan", 100, 400, 0, 0),
        Span("msm.buckets", 400, 600, 0, 0),
        Span("device.sync", 450, 550, 2, 0),
        Span("groth16.assemble", 700, 1000, 0, 0),
    ]
    events = [
        _Event(tr.CLOCK_MARK, "DeviceType.CPU", S + 0, 5, 1),
        _Event(tr.CLOCK_MARK, "DeviceType.CUDA", S + 0, 5, 0),  # the range's image
        _Event("cudaLaunchKernel", "DeviceType.CPU", S + 150, 5, 7),
        _Event("cudaLaunchKernel", "DeviceType.CPU", S + 410, 5, 8),
        _Event("cudaMemcpyAsync", "DeviceType.CPU", S + 460, 5, 9),
        _Event("void (anonymous namespace)::g1_padd_kernel(unsigned int const*)",
               "DeviceType.CUDA", S + 200, 100, 7),
        _Event("void at::native::elementwise_kernel<128, 2, direct_copy>(int)",
               "DeviceType.CUDA", S + 420, 50, 8),      # starts under the sync: launched earlier
        _Event("Memcpy HtoD (Pageable -> Device)", "DeviceType.CUDA", S + 480, 20, 9),
        _Event("void orphan_kernel()", "DeviceType.CUDA", S + 800, 10, 99),
    ]
    device, launches, offset = tr.device_record(_Prof(events), clock_mark=0.0)
    assert offset == pytest.approx(1.0)
    assert len(device) == 4 and set(launches) == {7, 8, 9}
    dm = tr.device_metrics(device, launches, offset, 0.0, 1000e-9, spans, proofs=1)
    assert dm["busy_s"] == pytest.approx(180e-9) and dm["window_s"] == pytest.approx(1000e-9)
    card = dm["card"]
    assert card["by_span"]["msm.scan"] == pytest.approx(100e-9)
    assert card["by_span"]["msm.buckets"] == pytest.approx(50e-9)
    assert card["by_span"]["device.sync"] == pytest.approx(20e-9)
    assert card["unattributed_s"] == pytest.approx(10e-9)
    copy = "void at::native::elementwise_kernel<128, 2, direct_copy>(int)"
    assert card["by_op"][copy] == {"msm.buckets": pytest.approx(50e-9)}
    assert dm["msm_card_glue_share"] == pytest.approx(100 * 70 / 170)
    assert dm["device_wait_ms"] == pytest.approx(100e-9 * 1e3)
    # idle 0-200, 300-420, 470-480, 500-800, 810-1000 by the innermost span
    assert dm["idle_s"] == pytest.approx(820e-9)
    assert dm["idle_under_spans_s"] == pytest.approx(820e-9)
    assert dict(dm["idle_by_span"]) == pytest.approx({
        "groth16.prove": 200e-9, "msm.scan": 200e-9, "msm.buckets": 70e-9,
        "device.sync": 60e-9, "groth16.assemble": 290e-9})


def test_idle_outside_every_span_and_kernel_names():
    spans = [Span("fl.round", 100, 200, -1, 0)]
    pieces = tr.innermost(spans)
    gaps = tr.idle_gaps([(150e-9, 160e-9)], 0.0, 300e-9)
    idle = tr.attribute_idle(gaps, pieces, spans)
    assert idle["fl.round"] == pytest.approx(90e-9) and idle["outside"] == pytest.approx(200e-9)
    assert tr.kernel_base("void (anonymous namespace)::g2_pdbl_kernel(int)") == "g2_pdbl_kernel"
    assert tr.kernel_base("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def test_trace_round_without_a_card_exits_1_with_an_error_line(capsys):
    assert not torch.cuda.is_available()
    assert tr.main(["--config", "reference", "--rounds", "1"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"config": "reference", "error": "torch sees no CUDA device"}
    assert not trace._on
