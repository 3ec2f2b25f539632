"""The port's circuit DSL refuses a hint that returns another number of
values than it declared, on both evaluators (the reference's
CompiledEvaluator truncates such a hint)."""

import pytest

from hotproofs_tpu_torch.circuits import gadgets as g
from hotproofs_tpu_torch.circuits.dsl import (CompiledEvaluator,
                                              compile_circuit, eval_witness)
from hotproofs_tpu_torch.circuits.blake3_compression import VESTA_PRIME as P


def _step(extra: int):
    """z_out = z_in^2 + the sum of a 2-value hint that returns 2 + extra
    values."""
    def step(ctx):
        z_out = ctx.declare_output("z_out", 1)
        z_in = ctx.declare_input("z_in", 1, public=True)
        hv = ctx.hint_vec(lambda z: [z + i for i in range(2 + extra)],
                          [z_in[0]], 2, name="hv")
        sq = g.mul(ctx, z_in[0], z_in[0], name="sq")
        ctx.bind(z_out[0], sq + hv[0] + hv[1])
    return step


def _eval(evaluator, step, layout):
    if evaluator == "EvalCtx":
        return eval_witness(step, layout, {"z_in": [5]}, check=False)
    return CompiledEvaluator(step, layout).eval({"z_in": [5]})


@pytest.mark.parametrize("evaluator", ["EvalCtx", "CompiledEvaluator"])
def test_hint_of_n_values_evaluates(evaluator):
    step = _step(0)
    _, layout = compile_circuit(step, P)
    w = _eval(evaluator, step, layout)
    assert int(w[1]) == 25 + 5 + 6


@pytest.mark.parametrize("evaluator", ["EvalCtx", "CompiledEvaluator"])
def test_hint_of_n_plus_one_values_raises(evaluator):
    step = _step(1)
    _, layout = compile_circuit(step, P)
    with pytest.raises(AssertionError):
        _eval(evaluator, step, layout)
