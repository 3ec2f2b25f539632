"""Constraint-system DSL with dual interpretation (build / eval).

The reference defines its constraint systems in circom
(circuits/blake3_common.circom, circuits/blake3_compression.circom,
circuits/blake3_nova.circom) and evaluates witnesses with a circom-emitted
sequential WASM calculator (build/*_js/witness_calculator.js). This module
replaces both with a single-source-of-truth gadget DSL:

  * ``BuildCtx`` walks the gadget code symbolically and produces the R1CS
    (sparse A, B, C in COO form) plus a named signal layout.
  * ``EvalCtx`` walks the *same* gadget code with concrete values and produces
    the witness vector, asserting every constraint as it goes (a built-in
    Az∘Bz=Cz self check).

Because both interpretations execute the same Python, signal allocation order
is identical by construction — the layout cannot drift from the evaluator.
The TPU-batched witness kernels (hotproofs_tpu/circuits/witness_jax.py) are
hand-optimised JAX mirrors validated against ``EvalCtx`` in tests.

Witness vector convention (matches the bellpepper synthesis order the
reference uses, rust_fold/src/utils.rs:17-88): index 0 is the constant ONE,
then declared outputs, then declared public inputs, then private inputs, then
auxiliary signals.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Int = int


@dataclass(frozen=True)
class LinExpr:
    """Linear combination  sum(coeff_i * w[idx_i]) + const  over the field."""

    terms: Tuple[Tuple[int, int], ...] = ()
    const: int = 0

    def __add__(self, other):
        if isinstance(other, LinExpr):
            return LinExpr(self.terms + other.terms, self.const + other.const)
        return LinExpr(self.terms, self.const + int(other))

    __radd__ = __add__

    def __neg__(self):
        return LinExpr(tuple((i, -c) for i, c in self.terms), -self.const)

    def __sub__(self, other):
        return self + (-other if isinstance(other, LinExpr) else -int(other))

    def __rsub__(self, other):
        return (-self) + int(other)

    def __mul__(self, k):
        if isinstance(k, LinExpr):
            raise TypeError("LinExpr*LinExpr is non-linear; use ctx.mul()")
        k = int(k)
        return LinExpr(tuple((i, c * k) for i, c in self.terms), self.const * k)

    __rmul__ = __mul__


Value = Union[LinExpr, int]


@dataclass
class Segment:
    name: str
    start: int
    length: int
    role: str  # "one" | "out" | "pub" | "priv" | "aux"


class BuildCtx:
    """Symbolic interpretation: collects R1CS rows and the signal layout."""

    is_build = True

    def __init__(self, modulus: int):
        self.p = modulus
        self.n_signals = 1  # signal 0 == constant 1
        self.segments: List[Segment] = [Segment("one", 0, 1, "one")]
        self._scope: List[str] = []
        # COO rows: list of (constraint_row, signal_col, coeff)
        self.A: List[Tuple[int, int, int]] = []
        self.B: List[Tuple[int, int, int]] = []
        self.C: List[Tuple[int, int, int]] = []
        self.n_constraints = 0
        self._io_exprs: Dict[str, List[LinExpr]] = {}
        self._frozen_io = False

    # ---- layout -----------------------------------------------------------
    def _alloc_block(self, name: str, n: int, role: str) -> List[LinExpr]:
        start = self.n_signals
        self.n_signals += n
        self.segments.append(Segment(self._qual(name), start, n, role))
        return [LinExpr(((start + i, 1),), 0) for i in range(n)]

    def _qual(self, name: str) -> str:
        return "/".join(self._scope + [name]) if self._scope else name

    def declare_output(self, name: str, n: int) -> List[LinExpr]:
        assert not self._frozen_io, "declare IO before any aux allocation"
        sigs = self._alloc_block(name, n, "out")
        self._io_exprs[name] = sigs
        return sigs

    def declare_input(self, name: str, n: int, public: bool) -> List[LinExpr]:
        assert not self._frozen_io, "declare IO before any aux allocation"
        sigs = self._alloc_block(name, n, "pub" if public else "priv")
        self._io_exprs[name] = sigs
        return sigs

    @contextmanager
    def scope(self, name: str):
        self._scope.append(name)
        try:
            yield
        finally:
            self._scope.pop()

    # ---- gadget interface -------------------------------------------------
    def one(self) -> LinExpr:
        return LinExpr(((0, 1),), 0)

    def hint(self, fn: Callable[..., int], deps: Sequence[Value],
             name: str = "h") -> LinExpr:
        """Allocate one auxiliary signal (value computed only in eval mode)."""
        self._frozen_io = True
        return self._alloc_block(name, 1, "aux")[0]

    def hint_vec(self, fn: Callable[..., Sequence[int]], deps: Sequence[Value],
                 n: int, name: str = "hv") -> List[LinExpr]:
        self._frozen_io = True
        return self._alloc_block(name, n, "aux")

    def enforce(self, a: Value, b: Value, c: Value) -> None:
        row = self.n_constraints
        self.n_constraints += 1
        for mat, lc in ((self.A, a), (self.B, b), (self.C, c)):
            lc = lc if isinstance(lc, LinExpr) else LinExpr((), int(lc))
            acc: Dict[int, int] = {}
            for idx, coeff in lc.terms:
                acc[idx] = acc.get(idx, 0) + coeff
            if lc.const:
                acc[0] = acc.get(0, 0) + lc.const
            for idx, coeff in acc.items():
                coeff %= self.p
                if coeff:
                    mat.append((row, idx, coeff))

    def bind(self, out_sig: LinExpr, expr: Value) -> None:
        """Constrain a declared output signal to equal a linear expression."""
        self.enforce(0, 0, out_sig - expr)

    def value_of(self, v: Value) -> int:  # pragma: no cover - build mode
        raise RuntimeError("values are not available in build mode")


class EvalCtx:
    """Concrete interpretation: computes the witness, checks constraints."""

    is_build = False

    def __init__(self, layout: "CircuitLayout",
                 inputs: Dict[str, Sequence[int]], check: bool = True):
        self.p = layout.modulus
        self.layout = layout
        self.check = check
        self.w: List[Optional[int]] = [None] * layout.n_signals
        self.w[0] = 1
        self._cursor_by_name = {s.name: s for s in layout.segments}
        self._aux_iter = iter(
            [s for s in layout.segments if s.role == "aux"])
        self._cur_seg: Optional[Segment] = None
        self._cur_off = 0
        self._io_vals: Dict[str, List[int]] = {}
        for seg in layout.segments:
            if seg.role in ("pub", "priv"):
                vals = [int(v) % self.p for v in inputs[seg.name]]
                assert len(vals) == seg.length, f"input {seg.name} length"
                for i, v in enumerate(vals):
                    self.w[seg.start + i] = v
                self._io_vals[seg.name] = vals

    # ---- layout mirrors ---------------------------------------------------
    def declare_output(self, name: str, n: int) -> List[LinExpr]:
        seg = self._cursor_by_name[name]
        return [LinExpr(((seg.start + i, 1),), 0) for i in range(n)]

    def declare_input(self, name: str, n: int, public: bool) -> List[int]:
        return list(self._io_vals[name])

    @contextmanager
    def scope(self, name: str):
        yield

    # ---- gadget interface -------------------------------------------------
    def one(self) -> int:
        return 1

    def _next_slots(self, n: int) -> int:
        if self._cur_seg is None or self._cur_off >= self._cur_seg.length:
            self._cur_seg = next(self._aux_iter)
            self._cur_off = 0
        seg = self._cur_seg
        assert self._cur_off + n <= seg.length, "allocation order mismatch"
        start = seg.start + self._cur_off
        self._cur_off += n
        return start

    def hint(self, fn, deps, name="h") -> int:
        v = int(fn(*[self.value_of(d) for d in deps])) % self.p
        self.w[self._next_slots(1)] = v
        return v

    def hint_vec(self, fn, deps, n, name="hv") -> List[int]:
        vs = [int(x) % self.p for x in fn(*[self.value_of(d) for d in deps])]
        assert len(vs) == n
        start = self._next_slots(n)
        for i, v in enumerate(vs):
            self.w[start + i] = v
        return vs

    def enforce(self, a, b, c) -> None:
        if self.check:
            av, bv, cv = self.value_of(a), self.value_of(b), self.value_of(c)
            assert (av * bv - cv) % self.p == 0, "constraint violated in eval"

    def bind(self, out_sig: LinExpr, expr) -> None:
        assert len(out_sig.terms) == 1 and out_sig.terms[0][1] == 1
        idx = out_sig.terms[0][0]
        self.w[idx] = self.value_of(expr)

    def value_of(self, v) -> int:
        if isinstance(v, LinExpr):
            acc = v.const
            for idx, coeff in v.terms:
                wv = self.w[idx]
                assert wv is not None, f"signal {idx} unset"
                acc += coeff * wv
            return acc % self.p
        return int(v) % self.p

    def witness(self) -> np.ndarray:
        assert all(v is not None for v in self.w), "unset signals remain"
        return np.array(self.w, dtype=object)


@dataclass
class CircuitLayout:
    modulus: int
    n_signals: int
    segments: List[Segment]

    def segment(self, name: str) -> Segment:
        for s in self.segments:
            if s.name == name:
                return s
        raise KeyError(name)

    @property
    def n_io(self) -> int:
        """Number of public signals (outputs + public inputs), excl. ONE."""
        return sum(s.length for s in self.segments if s.role in ("out", "pub"))


@dataclass
class R1CS:
    """Sparse R1CS over a prime field: Az ∘ Bz = Cz for z = (1, x, w)."""

    modulus: int
    n_signals: int
    n_constraints: int
    n_io: int
    A: Tuple[np.ndarray, np.ndarray, np.ndarray]  # rows, cols, vals(object)
    B: Tuple[np.ndarray, np.ndarray, np.ndarray]
    C: Tuple[np.ndarray, np.ndarray, np.ndarray]
    layout: CircuitLayout

    def matvec(self, mat, z: np.ndarray) -> np.ndarray:
        rows, cols, vals = mat
        out = np.zeros(self.n_constraints, dtype=object)
        np.add.at(out, rows, vals * z[cols])
        return np.mod(out, self.modulus)

    def is_satisfied(self, z: np.ndarray) -> bool:
        az = self.matvec(self.A, z)
        bz = self.matvec(self.B, z)
        cz = self.matvec(self.C, z)
        return bool(np.all((az * bz - cz) % self.modulus == 0))


def _coo(entries: List[Tuple[int, int, int]]):
    rows = np.array([e[0] for e in entries], dtype=np.int64)
    cols = np.array([e[1] for e in entries], dtype=np.int64)
    vals = np.array([e[2] for e in entries], dtype=object)
    return rows, cols, vals


def compile_circuit(gadget: Callable, modulus: int) -> Tuple[R1CS, CircuitLayout]:
    """Run `gadget(ctx)` in build mode and return the R1CS + layout."""
    ctx = BuildCtx(modulus)
    gadget(ctx)
    layout = CircuitLayout(modulus, ctx.n_signals, ctx.segments)
    r1cs = R1CS(
        modulus=modulus,
        n_signals=ctx.n_signals,
        n_constraints=ctx.n_constraints,
        n_io=layout.n_io,
        A=_coo(ctx.A),
        B=_coo(ctx.B),
        C=_coo(ctx.C),
        layout=layout,
    )
    return r1cs, layout


def eval_witness(gadget: Callable, layout: CircuitLayout,
                 inputs: Dict[str, Sequence[int]], check: bool = True) -> np.ndarray:
    """Run `gadget(ctx)` in eval mode and return the full witness vector."""
    ctx = EvalCtx(layout, inputs, check=check)
    gadget(ctx)
    return ctx.witness()


# ---------------------------------------------------------------------------
# Compiled (tape) evaluator: record the gadget walk once, replay per call.
# ---------------------------------------------------------------------------


class _TraceCtx(BuildCtx):
    """Symbolic walk that records an execution TAPE instead of constraints.

    Any gadget that builds under BuildCtx is control-flow-independent of
    input values (BuildCtx already walks it with symbolic LinExprs), so one
    recorded walk replays for every input assignment. Replaying the tape
    skips all gadget-structure Python (loops, scopes, LinExpr allocation) —
    the dominant cost of per-step EvalCtx synthesis on the recursive-prove
    hot path (nova/recursive.py Side.synthesize)."""

    def __init__(self, modulus: int):
        super().__init__(modulus)
        # ops: ("hint", fn, deps_desc, start) | ("hintv", fn, deps_desc,
        # start, n) | ("bind", idx, desc); desc = (const, ((idx, coeff)...))
        self.tape: List[tuple] = []

    @staticmethod
    def _desc(v: Value):
        if isinstance(v, LinExpr):
            return (v.const, v.terms)
        return (int(v), ())

    def hint(self, fn, deps, name="h") -> LinExpr:
        sig = super().hint(fn, deps, name)
        self.tape.append(("hint", fn, tuple(self._desc(d) for d in deps),
                          sig.terms[0][0]))
        return sig

    def hint_vec(self, fn, deps, n, name="hv") -> List[LinExpr]:
        sigs = super().hint_vec(fn, deps, n, name)
        self.tape.append(("hintv", fn, tuple(self._desc(d) for d in deps),
                          sigs[0].terms[0][0], n))
        return sigs

    def bind(self, out_sig: LinExpr, expr: Value) -> None:
        super().bind(out_sig, expr)
        assert len(out_sig.terms) == 1 and out_sig.terms[0][1] == 1
        self.tape.append(("bind", out_sig.terms[0][0], self._desc(expr)))

    def enforce(self, a: Value, b: Value, c: Value) -> None:
        # Constraints still recorded (for optional replay checking).
        super().enforce(a, b, c)


class CompiledEvaluator:
    """Replayable witness generator for one gadget; bit-identical output to
    eval_witness (tests/test_witness_jax.py::test_compiled_evaluator)."""

    def __init__(self, gadget: Callable, layout: CircuitLayout):
        ctx = _TraceCtx(layout.modulus)
        gadget(ctx)
        assert ctx.n_signals == layout.n_signals, "tape/layout drift"
        self.p = layout.modulus
        self.layout = layout
        self.tape = ctx.tape
        self.inputs_segs = [s for s in layout.segments
                            if s.role in ("pub", "priv")]
        # Constraint triples for optional checking, in COO-free desc form.
        self._cons = None
        self._trace_ctx = ctx

    def _check_descs(self):
        if self._cons is None:
            # Rebuild per-row (a, b, c) descriptors from the trace's COO.
            rows = {}
            for mat_i, mat in enumerate((self._trace_ctx.A,
                                         self._trace_ctx.B,
                                         self._trace_ctx.C)):
                for r, cidx, coeff in mat:
                    rows.setdefault(r, ([], [], []))[mat_i].append(
                        (cidx, coeff))
            self._cons = [rows.get(r, ([], [], []))
                          for r in range(self._trace_ctx.n_constraints)]
        return self._cons

    def eval(self, inputs: Dict[str, Sequence[int]],
             check: bool = False) -> np.ndarray:
        p = self.p
        w: List[Optional[int]] = [None] * self.layout.n_signals
        w[0] = 1
        for seg in self.inputs_segs:
            vals = inputs[seg.name]
            assert len(vals) == seg.length, f"input {seg.name} length"
            st = seg.start
            for i, v in enumerate(vals):
                w[st + i] = int(v) % p

        def ev(desc):
            acc, terms = desc
            for idx, coeff in terms:
                acc += coeff * w[idx]
            return acc % p

        for op in self.tape:
            tag = op[0]
            if tag == "bind":
                w[op[1]] = ev(op[2])
            elif tag == "hint":
                _, fn, deps, start = op
                w[start] = int(fn(*[ev(d) for d in deps])) % p
            else:  # hintv
                _, fn, deps, start, n = op
                vs = fn(*[ev(d) for d in deps])
                for i in range(n):
                    w[start + i] = int(vs[i]) % p
        assert all(v is not None for v in w), "unset signals remain"
        if check:
            lin = lambda pairs: sum(c * w[i] for i, c in pairs) % p
            for a, b, c in self._check_descs():
                assert (lin(a) * lin(b) - lin(c)) % p == 0, \
                    "constraint violated in compiled eval"
        return np.array(w, dtype=object)
