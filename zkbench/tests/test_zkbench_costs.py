"""The cost files equal zkfl_tpu_torch/costs.py, every op the program
launches has one, and the roofline arithmetic is right on a hand-made
launch list."""

import json
from pathlib import Path

import pytest

from zkbench.costs import CostTable, load_peaks
from zkbench.metrics import field_kernel_roofline, msm_glue_share, point_kernel_roofline
from types import SimpleNamespace as RunData

COSTS = Path(__file__).resolve().parents[1] / "costs"
FILES = sorted(p.stem for p in COSTS.glob("*.json"))


def program_ops():
    from zkfl_tpu_torch.ops.limb_kernels import _OPS

    ops = [f"{f}.{op}" for f in ("fr", "fq") for op in _OPS]
    return ops + ["fr.butterfly", "fr.normalize_raw", "fr.poseidon",
                  "g1.padd", "g1.pdbl", "g2.padd", "g2.pdbl"]


def test_every_launched_op_has_a_cost_file():
    assert sorted(program_ops()) == FILES


@pytest.mark.parametrize("op", FILES)
def test_cost_file_equals_the_program_cost_model(op):
    from zkfl_tpu_torch import costs

    c = json.loads((COSTS / f"{op}.json").read_text())
    if "width_arg" in c:
        for t in range(2, 18):
            assert (c["madds_per_lane_by_width"][str(t)], c["bytes_per_lane_by_width"][str(t)]) \
                == costs.op_cost(f"{op} t={t}")
    else:
        assert (c["madds_per_lane"], c["bytes_per_lane"]) == costs.op_cost(op)


def test_peaks_equal_the_program_cost_model():
    from zkfl_tpu_torch import costs

    peaks = load_peaks()
    assert peaks["hbm_bytes_per_s"] == costs.HBM_BYTES_PER_S
    assert (peaks["sms"], peaks["int32_lanes_per_sm"]) == (costs.SMS, costs.INT32_LANES)


@pytest.mark.parametrize("op,args", [
    ("g1.padd", (0, 0, 0, 1 << 19, 0)),
    ("g1.pdbl", (0, 0, 1 << 14, 8, 0)),
    ("g2.pdbl", (0, 0, 4096, 3, 0)),
    ("fr.butterfly", (0, 0, 0, 0, 0, 1 << 18, 0)),
    ("fq.add", (1, 1, 0, 0, 0, 0, 0, 1 << 16, 0)),
    ("fr.poseidon", (3, 0, 0, 0, 0, 1 << 20, 0)),
])
def test_least_time_of_one_launch(op, args):
    from zkfl_tpu_torch import costs

    table = CostTable(load_peaks(), 1980.0)
    name = op
    lanes = args[table.cost(op)["lanes_arg"]]
    if op == "fr.poseidon":
        name = f"fr.poseidon t={args[0]}"
    elif op.endswith("pdbl"):
        name = f"{op} times={args[3]}"
    want_ms, _ = costs.bound(name, lanes, 1980.0)
    assert table.least_s(op, args) * 1e3 == pytest.approx(want_ms, rel=1e-12)


def test_op_without_a_cost_file_raises():
    with pytest.raises(KeyError):
        CostTable(load_peaks(), 1980.0).least_s("g3.padd", (0, 0, 0, 1, 0))


class FakeTracer:
    def __init__(self, launches, msm_wall_s):
        self.launches, self.msm_wall_s = launches, msm_wall_s


def test_roofline_and_glue_arithmetic():
    rows = [  # (class, least_s, card_s): the profiled kernels
        ("point", 1.0, 4.0), ("point", 2.0, 4.0), ("point", 1.0, 2.0),
        ("field", 0.5, 2.0), ("field", 0.25, 0.5),
    ]
    launches = [  # (op, class, least_s, card_s, msm index): the window's, by events
        ("g1.padd", "point", 1.0, 4.0, 0),
        ("g1.pdbl", "point", 2.0, 4.0, 1),
        ("g2.padd", "point", 1.0, 2.0, None),
        ("fr.mont_mul", "field", 0.25, 0.5, 0),
    ]
    run = RunData(tracer=FakeTracer(launches, [10.0, 6.0]), on_device=True,
                  activity={"kernel_rows": rows})
    assert point_kernel_roofline.read(run) == pytest.approx(100 * 4.0 / 10.0)
    assert field_kernel_roofline.read(run) == pytest.approx(100 * 0.75 / 2.5)
    assert msm_glue_share.read(run) == pytest.approx(100 * (1 - 8.0 / 16.0))
    off = RunData(tracer=FakeTracer(launches, [10.0]), on_device=False, activity=None)
    assert point_kernel_roofline.read(off) is None and msm_glue_share.read(off) is None
    points_only = RunData(activity={"kernel_rows": rows[:3]})
    assert field_kernel_roofline.read(points_only) is None


def test_kernels_matched_to_launches_only_where_the_counts_agree():
    from zkbench.trace import match_kernels

    launches = [("g1.padd", "point", 1.0, 9.0, 0), ("fr.mont_mul", "field", 0.5, 9.0, None),
                ("g1.padd", "point", 1.0, 9.0, 0)]
    own = [(0.0, 2.0, "g1_padd_kernel(...)"), (3.0, 4.0, "void field_ew_kernel<zk::Fr, 0>()"),
           (5.0, 8.0, "g1_padd_kernel(...)")]
    rows, ops = match_kernels(launches, own)
    assert rows == [("point", 1.0, 2.0), ("field", 0.5, 1.0), ("point", 1.0, 3.0)]
    assert ops == {"g1.padd": 5.0, "fr.mont_mul": 1.0}
    rows, ops = match_kernels(launches, own[:2])
    assert rows is None and ops == {"g1_padd_kernel": 2.0, "field_ew_kernel": 1.0}
    unmatched = RunData(tracer=None, on_device=True, activity={"kernel_rows": None})
    assert point_kernel_roofline.read(unmatched) is None
    assert field_kernel_roofline.read(unmatched) is None


def test_idle_gaps_and_their_spans():
    from zkbench.trace import attribute, idle_gaps

    busy = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (9.5, 11.0)]
    gaps = idle_gaps(busy, 0.0, 10.0)
    assert gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 9.5)]
    spans = [(0.0, 10.0, "round"), (2.5, 5.5, "witness"), (3.5, 4.5, "verify")]
    by = attribute(gaps, spans)
    assert by == pytest.approx({"round": 1.0 + 3.5, "witness": 1.0, "verify": 1.0})
    assert attribute([(20.0, 21.0)], spans) == {"between_rounds": 1.0}


@pytest.mark.parametrize("name,base", [
    ("(anonymous namespace)::g1_padd_kernel(unsigned int const*, unsigned int*, long long)",
     "g1_padd_kernel"),
    ("void field_ew_kernel<zk::Fr, 0>(unsigned int const*, unsigned int*)", "field_ew_kernel"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::"
     "native::direct_copy_kernel_cuda(at::T", "elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_kernel_base(name, base):
    from zkbench.trace import kernel_base

    assert kernel_base(name) == base
