"""The least time the card could take for one kernel launch, from the
launch's own arguments and the op's cost file (``costs/<op>.json``): the
larger of its bytes over the memory rate and its 32-bit multiply-adds over
the integer rate (``peaks.json``, at the card's maximum SM clock).

A cost file holds the op's fewest multiply-adds and bytes per lane, and
which of the arguments that ``backend.launch`` passes on after the entry
point and the op name carry the lane count (``lanes_arg``), the doubling
count (``times_arg``: the multiply-adds repeat, the bytes do not) or the
Poseidon width (``width_arg``: the costs are then tables by width).
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())


def int32_rate(peaks: dict, sm_mhz: float) -> float:
    """32-bit multiply-adds a second at ``sm_mhz``."""
    return peaks["sms"] * peaks["int32_lanes_per_sm"] * sm_mhz * 1e6


class CostTable:
    """Cost files by op name, read once each; an op without one raises."""

    def __init__(self, peaks: dict, sm_mhz: float, directory: Path = HERE / "costs"):
        self.dir = directory
        self.bytes_rate = peaks["hbm_bytes_per_s"]
        self.madd_rate = int32_rate(peaks, sm_mhz)
        self.files = {}

    def cost(self, op: str) -> dict:
        if op not in self.files:
            path = self.dir / f"{op}.json"
            if not path.exists():
                raise KeyError(f"kernel op {op!r} has no cost file {path.name}")
            self.files[op] = json.loads(path.read_text())
        return self.files[op]

    def least_s(self, op: str, args) -> float:
        """The least seconds of one launch of ``op`` with these arguments."""
        c = self.cost(op)
        lanes = int(args[c["lanes_arg"]])
        if "width_arg" in c:
            width = str(int(args[c["width_arg"]]))
            madds, nbytes = c["madds_per_lane_by_width"][width], c["bytes_per_lane_by_width"][width]
        else:
            madds, nbytes = c["madds_per_lane"], c["bytes_per_lane"]
        if "times_arg" in c:
            madds *= int(args[c["times_arg"]])
        return max(lanes * nbytes / self.bytes_rate, lanes * madds / self.madd_rate)
