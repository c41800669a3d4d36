"""R1CS constraint-system builder.

Replaces the reference's circom compiler (invoked at
tests/full_system_simulation.mjs:703-711): instead of a DSL we express the
three ZK-FL constraint systems programmatically as sparse A/B/C matrices over
BN254-Fr, and generate witnesses in the same pass.

Design:
  * Wire layout follows snarkjs conventions so public-signal indices line up
    with the reference server's positional checks
    (full_system_simulation.mjs:889-891, :999-1001):
      wire 0          = constant 1
      wires 1..n_pub  = public inputs, template declaration order
      then private inputs, then internal wires.
  * Building IS witness generation: circuit functions receive concrete input
    values and eagerly compute every internal wire while emitting
    constraints.  Constraint STRUCTURE is value-independent (static control
    flow only, hints arrive as private inputs or in-pass computations), so
    running with dummy inputs yields the canonical R1CS for trusted setup.
  * Linear combinations are free (folded into constraint rows); only
    multiplications allocate wires, mirroring circom's cost model.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..field.bn254 import FR

Coeffs = Dict[int, int]


class LinComb:
    """Sparse linear combination of wires, with its concrete value.

    In witness-only mode (cs.witness_only) ``terms`` is None and all
    operations take a value-only fast path: building a witness then costs a
    plain arithmetic evaluation instead of symbolic dict merging (~50x
    faster for the Poseidon-heavy circuits).  The same circuit code runs in
    both modes, so wire allocation order is identical by construction.
    """

    __slots__ = ("cs", "terms", "value")

    def __init__(self, cs: "ConstraintSystem", terms: Optional[Coeffs], value: int):
        self.cs = cs
        self.terms = terms
        self.value = value % FR

    # -- arithmetic -------------------------------------------------------
    def _coerce(self, other) -> "LinComb":
        if isinstance(other, LinComb):
            return other
        return self.cs.constant(other)

    def __add__(self, other) -> "LinComb":
        other = self._coerce(other)
        if self.terms is None:
            return LinComb(self.cs, None, self.value + other.value)
        terms = dict(self.terms)
        for w, c in other.terms.items():
            nc = (terms.get(w, 0) + c) % FR
            if nc:
                terms[w] = nc
            else:
                terms.pop(w, None)
        return LinComb(self.cs, terms, self.value + other.value)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other) -> "LinComb":
        other = self._coerce(other)
        return self + (other * (FR - 1))

    def __rsub__(self, other):
        return self._coerce(other) - self

    def __neg__(self):
        return self * (FR - 1)

    def __mul__(self, other) -> "LinComb":
        if isinstance(other, int):
            k = other % FR
            if self.terms is None:
                return LinComb(self.cs, None, self.value * k)
            return LinComb(self.cs, {w: c * k % FR for w, c in self.terms.items() if c * k % FR}, self.value * k)
        # LinComb * LinComb allocates a product wire + one R1CS constraint.
        return self.cs.mul(self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def is_constant(self) -> bool:
        return self.terms is not None and all(w == 0 for w in self.terms)


@dataclass
class ConstraintSystem:
    """Mutable R1CS under construction, carrying the witness alongside."""

    name: str = "circuit"
    values: List[int] = field(default_factory=lambda: [1])
    constraints: List[Tuple[Coeffs, Coeffs, Coeffs]] = field(default_factory=list)
    pub_names: List[str] = field(default_factory=list)
    n_private_inputs: int = 0
    witness_only: bool = False
    _inputs_done: bool = False

    # -- wires ------------------------------------------------------------
    @property
    def n_pub(self) -> int:
        return len(self.pub_names)

    @property
    def n_wires(self) -> int:
        return len(self.values)

    def constant(self, k: int) -> LinComb:
        k %= FR
        if self.witness_only:
            return LinComb(self, None, k)
        return LinComb(self, {0: k} if k else {}, k)

    def zero(self) -> LinComb:
        return self.constant(0)

    def one(self) -> LinComb:
        return self.constant(1)

    def _new_wire(self, value: int) -> int:
        self.values.append(value % FR)
        return len(self.values) - 1

    def public_input(self, name: str, value: int) -> LinComb:
        if self._inputs_done or self.n_private_inputs:
            raise RuntimeError("public inputs must be declared before private inputs")
        w = self._new_wire(value)
        self.pub_names.append(name)
        return LinComb(self, None if self.witness_only else {w: 1}, value)

    def public_inputs(self, name: str, values: Sequence[int]) -> List[LinComb]:
        return [self.public_input(f"{name}[{i}]", v) for i, v in enumerate(values)]

    def private_input(self, name: str, value: int) -> LinComb:
        self.n_private_inputs += 1
        w = self._new_wire(value)
        return LinComb(self, None if self.witness_only else {w: 1}, value)

    def private_inputs(self, name: str, values: Sequence[int]) -> List[LinComb]:
        return [self.private_input(f"{name}[{i}]", v) for i, v in enumerate(values)]

    def witness_wire(self, value: int) -> LinComb:
        """Internal (hint) wire; value computed by the builder."""
        w = self._new_wire(value)
        return LinComb(self, None if self.witness_only else {w: 1}, value)

    # -- constraints ------------------------------------------------------
    def enforce(self, a: LinComb, b: LinComb, c: LinComb):
        """Add constraint a * b = c (no-op in witness-only mode)."""
        if self.witness_only:
            return
        self.constraints.append((dict(a.terms), dict(b.terms), dict(c.terms)))

    def enforce_equal(self, a: LinComb, b: LinComb):
        """a == b as the linear constraint (a - b) * 1 = 0."""
        self.enforce(a - b, self.one(), self.zero())

    def enforce_zero(self, a: LinComb):
        self.enforce(a, self.one(), self.zero())

    def enforce_bool(self, a: LinComb):
        """a * (a - 1) = 0."""
        self.enforce(a, a - 1, self.zero())

    def mul(self, a: LinComb, b: LinComb) -> LinComb:
        out = self.witness_wire(a.value * b.value % FR)
        self.enforce(a, b, out)
        return out

    def square(self, a: LinComb) -> LinComb:
        return self.mul(a, a)

    # -- witness / checking ----------------------------------------------
    def eval_lc(self, terms: Coeffs) -> int:
        return sum(c * self.values[w] for w, c in terms.items()) % FR

    def is_satisfied(self) -> bool:
        return self.first_unsatisfied() is None

    def first_unsatisfied(self) -> Optional[int]:
        for j, (a, b, c) in enumerate(self.constraints):
            if self.eval_lc(a) * self.eval_lc(b) % FR != self.eval_lc(c):
                return j
        return None

    @property
    def public_signals(self) -> List[int]:
        return self.values[1 : 1 + self.n_pub]

    @property
    def witness(self) -> List[int]:
        return list(self.values)

    def stats(self) -> dict:
        return {
            "name": self.name,
            "constraints": len(self.constraints),
            "wires": self.n_wires,
            "public_inputs": self.n_pub,
            "private_inputs": self.n_private_inputs,
        }
