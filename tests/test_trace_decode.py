"""The trace reduction of scripts/trace_decode.py on small recorded inputs:
busy time as the union of op intervals, and HLO ops mapped to the named
scopes of the decode step."""

import importlib.util
import os

import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                     "trace_decode.py")


@pytest.fixture(scope="module")
def td():
    spec = importlib.util.spec_from_file_location("trace_decode", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("events, want", [
    ([], 0),
    ([("a", 0, 10), ("b", 20, 5)], 15),           # apart
    ([("a", 0, 10), ("b", 5, 10)], 15),           # overlapping
    ([("a", 0, 30), ("b", 5, 10), ("c", 40, 1)], 31),   # nested
    ([("b", 5, 10), ("a", 0, 10)], 15),           # out of order
])
def test_busy_is_union_of_intervals(td, events, want):
    assert td.busy_ns(events) == want


def test_scopes_by_op_uses_trace_names(td):
    hlo = "\n".join([
        '  %gemm_fusion_dot.8 = f32[1] fusion(%a), metadata={op_name='
        '"jit(f)/while/body/ffn/dot_general" scheduling_name="x"}',
        '  %loop_transpose_fusion = bf16[2] fusion(%b), metadata={op_name='
        '"jit(f)/while/body/attention/transpose"}',
        '  %fusion.3 = f32[] fusion(%c), metadata={op_name="jit(f)/'
        'lm_head/dot_general"}',
        '  %copy.1 = f32[] copy(%d), metadata={op_name="jit(f)/while"}',
        '  %bitcast.2 = f32[] bitcast(%e)',
    ])
    assert td.scopes_by_op(hlo) == {
        "gemm_fusion_dot_8": "ffn", "loop_transpose_fusion": "attention",
        "fusion_3": "lm_head", "copy_1": "other"}


def test_refuses_to_run_without_gpu(td, tmp_path):
    """Off the GPU the script measures nothing unless asked for --tiny."""
    import jax
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    assert td.main(["--out", str(tmp_path)]) == 1
