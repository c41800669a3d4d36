"""Run one benchmark cell once and print its result as the last line.

    python3 -m zkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in BENCHMARK.json) names a
configuration, ``zkbench/configs/<config>.json``, and a traffic mix,
``zkbench/traffic/<traffic>.json``; the mix names its kind, a module
``zkbench/kinds/<kind>.py`` that drives the program (``zkfl_tpu_torch``).
The metrics that BENCHMARK.json lists for the cell are read by
``zkbench/metrics/<name>.py``: its end-to-end ones with ``--trace 0``, its
per-layer ones with ``--trace 1``.

A run: set-up (imports, kernel build or load, circuits and keys from the
cache under ``build/zkbench/``, one warm-up round of the cell's traffic),
then rounds in a closed loop, one in flight, until ``--seconds`` have
passed, then the judge (``zkbench/plain``), which decides ``correct``.
A traced run adds its taps after the warm-up, and after the window
profiles a few more rounds (the traffic's ``profile_rounds``) with
``torch.profiler``.  Without the CUDA devices the cell asks for it exits
2 and prints no result; ``--rehearse DIR`` runs the cell on the CPU at
the configuration's micro size, its caches in DIR, for the harness's own
tests, and reports no device metric.
"""

from __future__ import annotations

import time

SETUP_T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from .costs import CostTable, load_peaks  # noqa: E402
from .host import HostWatch  # noqa: E402
from .plain.judge import judge  # noqa: E402
from .trace import NullSpans, Tracer  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zkfl_tpu")
TOP_OPS = 10


def round_seed(seed: int, index: int) -> int:
    """The seed of round ``index`` of a run (-1: its warm-up round)."""
    digest = hashlib.sha256(f"zkbench-round|{seed}|{index}".encode()).digest()
    return int.from_bytes(digest[:4], "big") & 0x7FFFFFFF


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", metavar="DIR", default=None,
                    help="run on the CPU at the micro size, caches in DIR (the harness's tests)")
    return ap.parse_args(argv)


def check_lines(checks: dict) -> list:
    return [f"check {name} {c['value']} {c['rule']} {c['limit']}" for name, c in checks.items()]


def passes(c: dict) -> bool:
    return c["value"] <= c["limit"] if c["rule"] == "<=" else c["value"] >= c["limit"]


def main(argv=None, fault=None) -> int:
    """One run; ``fault`` (zkbench/control.py's only) makes a context
    manager that is entered around everything after the set-up's imports."""
    args = parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"zkbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    rehearse = args.rehearse is not None
    artifacts = (Path(args.rehearse) if rehearse
                 else ROOT / "build" / "zkbench" / "artifacts" / cell["config"]).resolve()
    artifacts.mkdir(parents=True, exist_ok=True)
    os.environ["ZKFL_ARTIFACTS_DIR"] = str(artifacts)
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    if rehearse:
        device = torch.device("cpu")
    elif not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"zkbench: {args.workload} needs {cell['chips']} CUDA device(s); torch sees {have}",
              file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda", 0)
    on_device = device.type == "cuda"

    from zkfl_tpu_torch import backend

    kind = importlib.import_module(f"zkbench.kinds.{traffic['kind']}")
    with (fault or contextlib.nullcontext)():
        if on_device:
            backend.lib()  # build the kernels, or load them from build/
        runner = kind.Cell(config, traffic, device, str(artifacts), rehearse)
        try:
            result = measure(args, traffic, runner, device, backend)
        finally:
            runner.close()
    records, data, counts, extra = result
    del runner
    gc.collect()

    found = forbidden_modules()
    if found:
        print(f"zkbench: JAX or the JAX package loaded in this process: {found}", file=sys.stderr)
        return 4

    t0 = time.perf_counter()
    ic_pins = load_json(HERE / "plain" / "ic" / f"{cell['config']}.json")
    verdict = judge(traffic["kind"], counts["judged_config"], records, counts["vks"],
                    ic_pins["rehearse" if rehearse else "measured"], traffic["proof_sample"],
                    args.seed)
    print(f"# judge: {time.perf_counter() - t0:.3f} s; IC sha256 {verdict['ic_sha256']}",
          file=sys.stderr)
    checks = {"rounds_failed": {"value": counts["failed"] + counts["outside_failed"],
                                "rule": "<=", "limit": 0}}
    for name in ("publics_wrong", "proofs_rejected", "aggregate_wrong", "keys_wrong"):
        checks[name] = {"value": verdict[name], "rule": "<=", "limit": 0}
    checks["rounds_judged"] = {"value": verdict["rounds_judged"], "rule": ">=", "limit": 1}
    checks["proofs_verified"] = {"value": verdict["proofs_verified"], "rule": ">=", "limit": 1}
    correct = all(passes(c) for c in checks.values())

    wanted = bench["per_layer"] if args.trace else bench["end_to_end"]
    metrics = {}
    for m in wanted:
        if applies(m, args.workload):
            value = importlib.import_module(f"zkbench.metrics.{m['name']}").read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": counts["attempted"], "failed": counts["failed"],
            "metrics": metrics, "device": extra["device"]}
    if "breakdown" in extra:
        line["breakdown"] = extra["breakdown"]
    line["checks"] = checks
    for text in check_lines(checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def measure(args, traffic, runner, device, backend):
    """Warm-up, the window and, traced, the profiled rounds; returns
    (records, the metric readers' data, counts, extra)."""
    import torch

    on_device = device.type == "cuda"
    spans = NullSpans()
    t0 = time.perf_counter()
    outside_failed = 0  # the warm-up and the profiled rounds
    try:
        runner.round(round_seed(args.seed, -1), spans)
    except AssertionError as exc:
        outside_failed += 1
        print(f"# warm-up round rejected by the program: {exc}", file=sys.stderr)
    print(f"# warm-up round: {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    runner.latencies.clear()
    sm_mhz = backend.max_sm_clock_mhz() if on_device else None
    tracer = None
    if args.trace:
        tracer = Tracer(CostTable(load_peaks(), sm_mhz or 0.0), runner.SPANS)
        tracer.install_spans()
        if on_device:
            tracer.install_device_taps()
        spans = tracer
    gc.collect()  # the set-up's garbage, before the window and not in it
    if on_device:
        torch.cuda.synchronize()
    launches0 = collections.Counter(backend.LAUNCHES)
    setup_s = time.perf_counter() - SETUP_T0

    records, attempted, failed, round_times = [], 0, 0, []
    host = HostWatch()
    host.start()
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    while not attempted or time.perf_counter() < deadline:
        attempted += 1
        r0 = time.perf_counter()
        try:
            with spans("round"):
                records.append(runner.round(round_seed(args.seed, attempted - 1), spans))
        except AssertionError as exc:
            failed += 1
            print(f"# round {attempted - 1} rejected by the program: {exc}", file=sys.stderr)
        if tracer is not None and on_device:
            tracer.settle()
        round_times.append(time.perf_counter() - r0)
    if on_device:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    print(host.stop(), file=sys.stderr)
    half = len(round_times) // 2
    if half:
        print(f"# rounds: mean {sum(round_times[:half]) / half:.4f} s in the first half, "
              f"{sum(round_times[half:]) / (len(round_times) - half):.4f} s in the second; "
              f"fastest {min(round_times):.4f} s, slowest {max(round_times):.4f} s",
              file=sys.stderr)
    launches = collections.Counter(backend.LAUNCHES) - launches0
    latencies = list(runner.latencies)
    window_records = len(records)
    proofs = sum(len(r["proofs"]) for r in records)
    print(f"# window: {window_s:.3f} s, {attempted} rounds, {failed} rejected, {proofs} proofs",
          file=sys.stderr)

    extra = {}
    activity = None
    if tracer is not None:
        if on_device:
            tracer.for_profile()
            tracer.start_profile()
            for k in range(traffic["profile_rounds"]):
                try:
                    with spans("round"):
                        records.append(runner.round(round_seed(args.seed, attempted + k), spans))
                except AssertionError as exc:
                    outside_failed += 1
                    print(f"# profiled round {k} rejected by the program: {exc}", file=sys.stderr)
            tracer.stop_profile()
            t1 = time.perf_counter()
            activity = tracer.device_activity()
            print(f"# profile read: {time.perf_counter() - t1:.3f} s, "
                  f"{activity['n_device_events']} device intervals, "
                  f"{activity['own_kernels']} of the program's kernels for "
                  f"{activity['launches']} launches", file=sys.stderr)
            for op, secs in activity["ops"].most_common(TOP_OPS):
                print(f"# device op {secs:.6f} s {op}", file=sys.stderr)
        tracer.uninstall()

    memory = torch.cuda.max_memory_allocated(device) if on_device else 0
    if on_device:
        extra["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                           "count": 1, "memory_peak_bytes": memory}
        print(f"# card: {backend.gpu_name_and_power_limit()}, max SM clock {sm_mhz} MHz",
              file=sys.stderr)
    else:
        extra["device"] = {"platform": "cpu", "kind": "rehearsal on the CPU", "count": 0,
                           "memory_peak_bytes": 0}
    if activity is not None:
        extra["device"]["busy_s"] = activity["busy_s"]
        extra["device"]["window_s"] = activity["window_s"]
        extra["breakdown"] = breakdown(activity)

    # What the metric readers (zkbench/metrics/<name>.py: read(run) -> a
    # number or None) read.
    data = SimpleNamespace(
        window_s=window_s, rounds_ok=window_records, setup_s=setup_s, latencies=latencies,
        proofs=proofs, launches=launches, on_device=on_device, tracer=tracer, activity=activity,
    )
    counts = {"attempted": attempted, "failed": failed, "outside_failed": outside_failed,
              "vks": runner.vks(), "judged_config": runner.judged_config()}
    return records, data, counts, extra


def breakdown(activity) -> dict:
    """The profiled rounds' device ops that took most time and their
    longest idle stretches by the span the host was in."""
    return {"device_ops": [[k, v] for k, v in activity["ops"].most_common(TOP_OPS)],
            "idle_gaps": [[k, v] for k, v in activity["gaps"].most_common(TOP_OPS)]}


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        # One string-hash seed for every run: the same dict and set layouts
        # in each process, one source less of run-to-run spread.
        os.execve(sys.executable, [sys.executable, "-m", "zkbench.run", *sys.argv[1:]],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
