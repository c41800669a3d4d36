"""Where a round's time goes on the first CUDA card, read from the port's
own spans and counters (zkfl_tpu_torch/trace.py) and from torch.profiler's
record of the card over a few more rounds.

    python -m zkfl_tpu_torch.scripts.trace_round [--config reference|prod]
        [--batch 0|1] [--rounds N] [--profile-rounds K] [--compare N]
        [--json-out PATH]

``reference``: ``fl.simulation.run_round`` at REFERENCE_CONFIG (3 clients;
``--batch 1`` proves each phase's clients as one batch); ``prod``: one
client's production round at N=128 (dataset and commitment, the balance and
sgd_step_v5 witnesses and proves, both verifies and the binding on root_D).
Tracing is on from the start, so the set-up's spans are kept apart.  Then:
a warm-up round; one round under ``torch.cuda.set_sync_debug_mode("warn")``,
every synchronising call site listed beside the ``device.syncs`` count of
the same round; ``--compare`` rounds untraced and as many traced, in turns,
and a micro-timing of one span (the cost of tracing); ``--rounds`` traced
rounds (the host metrics); ``--profile-rounds`` rounds under the profiler
(the device metrics).

Printed, on standard error: ``# setup spans``, ``# spans`` (seconds and
self seconds by name), ``# counters``, ``# idle under program spans``,
``# idle by program span``, ``# card by launching span``, ``# direct_copy
by launching span``; on standard output one JSON line with the six
metrics:

- ``witness_hash_share`` (%): ``r1cs.poseidon`` inside ``r1cs.witness``
  over ``r1cs.witness``;
- ``host_scalar_mul_ms`` (ms a proof): ``groth16.scalar_mul`` inside
  ``groth16.assemble`` or ``groth16.verify``: the host library's calls,
  one a proof's assembly, one a verify's vk_x;
- ``pipeline_host_ms`` (ms a proof): the ``pipeline.*`` spans less the
  ``device.sync`` spans inside them;
- ``syncs_per_round``: ``device.syncs`` over the traced rounds, a round;
- ``device_wait_ms`` (ms a proof): ``device.sync`` in the profiled rounds;
- ``msm_card_glue_share`` (%): of the card time launched under ``msm.*``
  spans, the share outside the K4/K6 point kernels (profiled rounds).

Without a CUDA device it prints one JSON line with an ``error`` and exits 1.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import itertools
import json
import os
import statistics
import sys
import timeit
import traceback
import warnings
from dataclasses import replace

from .. import trace

POINT_KERNELS = ("g1_padd_kernel", "g1_pdbl_kernel", "g2_padd_kernel", "g2_pdbl_kernel")
CLOCK_MARK = "zkfl_tpu_torch.trace.clock"
TOP = 12


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- the host metrics, from a taken span list ----------------------------------


def host_metrics(spans, counters, proofs: int, rounds: int) -> dict:
    """witness_hash_share, host_scalar_mul_ms, pipeline_host_ms and
    syncs_per_round of the traced rounds (None where nothing was read)."""
    dur = [s.end_ns - s.start_ns for s in spans]
    witness = sum(d for s, d in zip(spans, dur) if s.name == "r1cs.witness")
    hashing = sum(d for i, (s, d) in enumerate(zip(spans, dur))
                  if s.name == "r1cs.poseidon" and trace.under(spans, i, ("r1cs.witness",)))
    scalar_mul = sum(d for i, (s, d) in enumerate(zip(spans, dur))
                     if s.name == "groth16.scalar_mul"
                     and trace.under(spans, i, ("groth16.assemble", "groth16.verify")))
    pipeline_names = {s.name for s in spans if s.name.startswith("pipeline.")}
    pipeline = sum(d for s, d in zip(spans, dur) if s.name in pipeline_names)
    waited = sum(d for i, (s, d) in enumerate(zip(spans, dur))
                 if s.name == "device.sync" and trace.under(spans, i, pipeline_names))
    per_proof = 1e6 * proofs if proofs else None
    return {
        "witness_hash_share": 100.0 * hashing / witness if witness else None,
        "host_scalar_mul_ms": scalar_mul / per_proof if per_proof and scalar_mul else None,
        "pipeline_host_ms": (pipeline - waited) / per_proof if per_proof and pipeline else None,
        "syncs_per_round": counters["device.syncs"] / rounds if rounds else None,
    }


def totals(spans) -> dict:
    """name -> [seconds, self seconds, calls]."""
    out = collections.defaultdict(lambda: [0.0, 0.0, 0])
    for s, own in zip(spans, trace.self_ns(spans)):
        row = out[s.name]
        row[0] += (s.end_ns - s.start_ns) / 1e9
        row[1] += own / 1e9
        row[2] += 1
    return dict(out)


# -- the card's record, laid on the spans --------------------------------------


def innermost(spans, offset: float = 0.0) -> list:
    """The spans as a timeline of pieces (start s, end s, index of the
    innermost span open there), shifted by ``offset`` seconds."""
    bounds = sorted({t for s in spans for t in (s.start_ns, s.end_ns)})
    order = sorted(range(len(spans)), key=lambda i: (spans[i].start_ns, i))
    pieces, stack, k = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while k < len(order) and spans[order[k]].start_ns <= a:
            stack.append(order[k])
            k += 1
        stack = [i for i in stack if spans[i].end_ns > a]
        if stack:
            inner = max(stack, key=lambda i: (spans[i].start_ns, i))
            pieces.append((a / 1e9 + offset, b / 1e9 + offset, inner))
    return pieces


def span_at(pieces, starts, t: float):
    """Index of the innermost span open at time ``t``, or None."""
    k = bisect.bisect_right(starts, t) - 1
    if k >= 0 and pieces[k][0] <= t < pieces[k][1]:
        return pieces[k][2]
    return None


def idle_gaps(intervals, w0: float, w1: float) -> list:
    """The stretches of [w0, w1] that no (start, end) interval covers."""
    gaps, reached = [], w0
    for s, t in sorted(intervals):
        if s > reached:
            gaps.append((reached, s))
        reached = max(reached, t)
    if w1 > reached:
        gaps.append((reached, w1))
    return gaps


def attribute_idle(gaps, pieces, spans) -> collections.Counter:
    """Each gap's seconds by the innermost span open during it; the rest
    under ``outside``."""
    out = collections.Counter()
    k = 0
    for s, t in gaps:
        covered = 0.0
        while k < len(pieces) and pieces[k][1] <= s:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < t:
            a, b, idx = pieces[j]
            part = min(b, t) - max(a, s)
            if part > 0:
                out[spans[idx].name] += part
                covered += part
            j += 1
        if t - s - covered > 0:
            out["outside"] += t - s - covered
    return out


def attribute_card(device, launches, pieces, spans) -> dict:
    """Each device interval (start, end, name, correlation id) by the
    program span open when its runtime call (``launches``: correlation id
    -> host start, on the profiler's clock) was made.  Returns the card
    seconds by span name, by device op (the profiler's name, cut at 120
    characters: torch's template arguments tell its copies apart) under
    each span, the seconds under
    ``msm.*`` spans split into the point kernels and the rest, and the
    seconds that found no launch or no span."""
    starts = [p[0] for p in pieces]
    msm_names = {x.name for x in spans if x.name.startswith("msm.")}
    in_msm = {}
    by_span = collections.Counter()
    by_op = collections.defaultdict(collections.Counter)
    msm_point = msm_other = unattributed = 0.0
    for s, t, name, corr in device:
        host = launches.get(corr)
        idx = span_at(pieces, starts, host) if host is not None else None
        if idx is None:
            unattributed += t - s
            continue
        by_span[spans[idx].name] += t - s
        by_op[name[:120]][spans[idx].name] += t - s
        if idx not in in_msm:
            in_msm[idx] = spans[idx].name in msm_names or trace.under(spans, idx, msm_names)
        if in_msm[idx]:
            if kernel_base(name) in POINT_KERNELS:
                msm_point += t - s
            else:
                msm_other += t - s
    return {"by_span": by_span, "by_op": by_op, "msm_point_s": msm_point,
            "msm_other_s": msm_other, "unattributed_s": unattributed}


def kernel_base(name: str) -> str:
    """A kernel's function name without namespace, template arguments or
    parameters: "void (anonymous namespace)::g1_padd_kernel(...)" ->
    "g1_padd_kernel"; a name without parentheses stays whole."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = min((i for i in (name.find("("), name.find("<")) if i >= 0), default=len(name))
    return name[:cut].rsplit("::", 1)[-1].strip()


def device_record(prof, clock_mark: float):
    """From a finished torch.profiler run: the device intervals (start,
    end, name, correlation id) and the runtime calls (correlation id ->
    start) on the profiler's clock, and the offset profiler clock - host
    clock (seconds), read from the ``CLOCK_MARK`` range."""
    events = prof.profiler.kineto_results.events()
    mark = next(e for e in events if e.name() == CLOCK_MARK)
    offset = mark.start_ns() / 1e9 - clock_mark
    device, launches = [], {}
    for e in events:
        start = e.start_ns() / 1e9
        if "CUDA" in str(e.device_type()):
            if e.name() == CLOCK_MARK:  # the range's image on the device's row
                continue
            device.append((start, start + e.duration_ns() / 1e9, e.name(), e.correlation_id()))
        elif e.name().startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = start
    return device, launches, offset


def device_metrics(device, launches, offset, w0, w1, spans, proofs) -> dict:
    """The profiled rounds: busy and idle seconds, the idle under program
    spans, card time by launching span, device_wait_ms and
    msm_card_glue_share.  ``w0``, ``w1``: the window on the host clock."""
    w0, w1 = w0 + offset, w1 + offset
    inside = [(max(s, w0), min(t, w1), n, c) for s, t, n, c in device if min(t, w1) > max(s, w0)]
    gaps = idle_gaps([(s, t) for s, t, _, _ in inside], w0, w1)
    idle = sum(t - s for s, t in gaps)
    pieces = innermost(spans, offset)
    by_idle = attribute_idle(gaps, pieces, spans)
    card = attribute_card(inside, launches, pieces, spans)
    msm_card = card["msm_point_s"] + card["msm_other_s"]
    wait = trace.seconds(spans, "device.sync")
    return {
        "window_s": w1 - w0, "busy_s": (w1 - w0) - idle, "idle_s": idle,
        "idle_under_spans_s": idle - by_idle.get("outside", 0.0), "idle_by_span": by_idle,
        "card": card,
        "device_wait_ms": 1e3 * wait / proofs if proofs else None,
        "msm_card_glue_share": 100.0 * card["msm_other_s"] / msm_card if msm_card else None,
    }


# -- the rounds ----------------------------------------------------------------


class ReferenceRounds:
    """``run_round`` at REFERENCE_CONFIG."""

    def __init__(self, device, batch: bool):
        from ..fl.config import REFERENCE_CONFIG
        from ..fl.prover import RoundProver
        from ..groth16.engine import TorchEngine

        self.cfg = REFERENCE_CONFIG
        self.prover = RoundProver(self.cfg, TorchEngine(device))
        self.batch = batch
        self.proofs = 3 * self.cfg.num_clients

    def round(self, seed: int) -> None:
        from ..fl.simulation import run_round

        server, _ = run_round(replace(self.cfg, seed=seed), prover=self.prover, verbose=False,
                              batch_clients=self.batch)
        summary = server.get_summary()
        if not summary["all_passed"]:
            raise AssertionError(f"round rejected: {summary}")


class ProdRounds:
    """One client's production round (``fl.prod.prod_round``)."""

    proofs = 2

    def __init__(self, device):
        from ..fl import prod
        from ..groth16.engine import TorchEngine

        self.prod = prod
        self.engine = TorchEngine(device)
        self.keys = prod.prod_keys(prod.CACHE_DIR, self.engine, log)

    def round(self, seed: int) -> None:
        checks = self.prod.prod_round(self.keys, self.engine, seed)
        if not all(checks.values()):
            raise AssertionError(f"production round rejected: {checks}")


def sync_sites(rounds, seed: int) -> collections.Counter:
    """One round under the sync debug mode: each synchronising call's
    innermost frame in the package (file:line function), counted."""
    import torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(root)]
        where = frames[-1] if frames else None
        if where is not None and where.filename == os.path.abspath(__file__):
            return  # the mode's own notice as it is switched on
        sites[f"{os.path.relpath(where.filename, os.path.dirname(root))}:{where.lineno} "
              f"{where.name}: {where.line}" if where else f"{filename}:{lineno}"] += 1

    shown = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rounds.round(seed)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown
    return sites


def span_cost() -> dict:
    """Nanoseconds of one ``with trace.span(...)`` off and on, and of a
    decorated call off over a plain one (200,000 each, the best of 5)."""
    n = 200_000

    def plain():
        return None

    def block():
        with trace.span("cost.probe"):
            pass

    decorated = trace.spanned("cost.probe")(plain)

    def per(fn) -> float:
        return min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e9

    trace.disable()
    out = {"span_off_ns": per(block), "decorated_call_off_ns": per(decorated) - per(plain)}
    trace.enable()
    out["span_on_ns"] = per(block)
    trace.take()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("reference", "prod"), default="reference")
    ap.add_argument("--batch", type=int, choices=(0, 1), default=1)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--profile-rounds", type=int, default=3)
    ap.add_argument("--compare", type=int, default=3,
                    help="rounds untraced and traced in turns, each")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"config": args.config, "error": "torch sees no CUDA device"}),
              flush=True)
        return 1
    trace.enable()
    from .. import backend

    device = backend.device("cuda")
    backend.lib()
    if args.config == "prod":
        rounds = ProdRounds(device)
    else:
        rounds = ReferenceRounds(device, bool(args.batch))
    seeds = itertools.count(1)
    rounds.round(next(seeds))  # warm-up
    setup, _ = trace.take()
    setup_s = {n: round(v[0], 6) for n, v in totals(setup).items() if n.startswith("setup.")}
    log("# setup spans: " + ", ".join(f"{n} {v} s" for n, v in setup_s.items()))
    result = {"config": args.config, "batch": getattr(rounds, "batch", None),
              "device": str(device), "gpu": backend.gpu_name_and_power_limit(),
              "setup_spans_s": setup_s}

    def timed_round(traced: bool) -> float:
        (trace.enable if traced else trace.disable)()
        torch.cuda.synchronize()
        t0 = trace.clock_ns()
        rounds.round(next(seeds))
        torch.cuda.synchronize()
        return (trace.clock_ns() - t0) / 1e9

    trace.take()
    sites = sync_sites(rounds, next(seeds))
    _, counters = trace.take()
    log(f"# sync debug: {sum(sites.values())} synchronising calls in one round; "
        f"device.syncs counted {counters['device.syncs']}")
    for site, n in sites.most_common():
        log(f"# sync {n} {site}")
    result["sync_sites"] = dict(sites)
    result["sync_debug_count"] = sum(sites.values())
    result["sync_counted"] = counters["device.syncs"]

    if args.compare:
        off, on = [], []
        for _ in range(args.compare):
            off.append(timed_round(False))
            on.append(timed_round(True))
        trace.take()
        result["compare"] = {"untraced_s": off, "traced_s": on,
                             "untraced_median_s": statistics.median(off),
                             "traced_median_s": statistics.median(on)}
        log(f"# rounds untraced {statistics.median(off):.4f} s, traced "
            f"{statistics.median(on):.4f} s (medians of {args.compare} in turns)")
        result["span_cost"] = span_cost()
        log(f"# span cost: {result['span_cost']}")

    trace.enable()
    trace.take()
    times = [timed_round(True) for _ in range(args.rounds)]
    spans, counters = trace.take()
    proofs = rounds.proofs * args.rounds
    metrics = host_metrics(spans, counters, proofs, args.rounds)
    result.update(rounds=args.rounds, proofs_a_round=rounds.proofs, round_s=times,
                  spans_a_round=len(spans) / args.rounds, counters=dict(counters))
    log(f"# traced rounds: {', '.join(f'{t:.4f}' for t in times)} s; "
        f"{len(spans) / args.rounds:.0f} spans a round")
    log("# counters: " + ", ".join(f"{k} {v}" for k, v in sorted(counters.items())))
    rows = sorted(totals(spans).items(), key=lambda kv: -kv[1][1])
    log("# spans (s, self s, calls): " + ", ".join(
        f"{n} {v[0]:.4f} {v[1]:.4f} {v[2]}" for n, v in rows))
    result["spans"] = {n: v for n, v in rows}

    metrics["device_wait_ms"] = metrics["msm_card_glue_share"] = None
    if args.profile_rounds:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(CLOCK_MARK):
                mark = trace.clock_ns() / 1e9
            w0 = trace.clock_ns() / 1e9
            for _ in range(args.profile_rounds):
                rounds.round(next(seeds))
            torch.cuda.synchronize()
            w1 = trace.clock_ns() / 1e9
        pspans, _ = trace.take()
        device_ev, launches, offset = device_record(prof, mark)
        dm = device_metrics(device_ev, launches, offset, w0, w1, pspans,
                            rounds.proofs * args.profile_rounds)
        metrics["device_wait_ms"] = dm["device_wait_ms"]
        metrics["msm_card_glue_share"] = dm["msm_card_glue_share"]
        card = dm["card"]
        log(f"# profiled {args.profile_rounds} rounds: busy {dm['busy_s']:.4f} of "
            f"{dm['window_s']:.4f} s; {len(device_ev)} device intervals, "
            f"{len(launches)} runtime calls")
        log(f"# idle under program spans: {dm['idle_under_spans_s']:.4f} of {dm['idle_s']:.4f} s")
        log("# idle by program span: " + ", ".join(
            f"{n} {v:.4f}" for n, v in dm["idle_by_span"].most_common(TOP)))
        log("# card by launching span: " + ", ".join(
            f"{n} {v:.4f}" for n, v in card["by_span"].most_common(TOP))
            + f"; unattributed {card['unattributed_s']:.4f} s")
        copies = collections.Counter()
        for op, under in card["by_op"].items():
            if "direct_copy" in op:
                copies.update(under)
        log("# direct_copy by launching span: " + ", ".join(
            f"{n} {v:.4f}" for n, v in copies.most_common(TOP)))
        result["profile"] = {
            "rounds": args.profile_rounds, "window_s": dm["window_s"], "busy_s": dm["busy_s"],
            "idle_s": dm["idle_s"], "idle_under_spans_s": dm["idle_under_spans_s"],
            "idle_by_span": dict(dm["idle_by_span"]), "card_by_span": dict(card["by_span"]),
            "card_by_op_and_span": {k: dict(v) for k, v in card["by_op"].items()},
            "unattributed_s": card["unattributed_s"], "msm_point_s": card["msm_point_s"],
            "msm_other_s": card["msm_other_s"],
        }
    result["metrics"] = metrics
    trace.disable()
    line = json.dumps(result)
    print(json.dumps({"config": args.config, "batch": result["batch"], "metrics": metrics}),
          flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
