"""The port's precision probe (plain version, the CPU path) against the JAX
package's probe kernels (``scripts/mxu_precision_probe.py``) in Pallas
interpret mode, on the CPU.

Interpret mode computes a true f32 product: ``_kernel_single`` on f32 data
does not round its operands to bf16 as the TPU's one-pass matrix unit
does. So stage A (a 0/1 selector against bf16 values, exact in any
precision) and stage C (the hi/lo split, whose parts are bf16 values) are
held against the interpret-mode kernels, and stage B (one pass on f32
data) against ``jnp.dot`` of the bf16-cast operands with f32 accumulation,
the product the card's tensor cores compute.

Tolerances: stage A exact; stage C within ``1e-6`` relative plus ``1e-6``
absolute (two f32 products summed in other orders); stage B within
``1e-6`` relative plus ``1e-6`` absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from scripts import mxu_precision_probe as jprobe
from tpudet_torch.kernels import precision_probe as kpp

torch.set_num_threads(2)


def interpret(kernel, x, m):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((x.shape[0], m.shape[1]),
                                               jnp.float32),
        interpret=True)(x, m))


@pytest.fixture(scope="module")
def stages():
    return kpp.probe_inputs()


def test_inputs_are_the_scripts(stages):
    """The port draws the script's inputs from ``RandomState(0)`` in its
    order, and rounds the bf16 values as ``jnp.asarray(.., bfloat16)``."""
    rng = np.random.RandomState(0)
    y0 = rng.randint(0, jprobe.K, jprobe.SP)
    v = np.asarray(jnp.asarray(rng.randn(jprobe.K, jprobe.N), jnp.bfloat16),
                   np.float32)
    x = rng.randn(jprobe.SP, jprobe.K).astype(np.float32)
    m01 = (rng.rand(jprobe.K, jprobe.N) < (4.0 / jprobe.K)).astype(np.float32)
    sel, vals, _, _ = stages["A_select_bf16_single_pass"]
    np.testing.assert_array_equal(sel.float().numpy().argmax(1), y0)
    np.testing.assert_array_equal(vals.float().numpy(), v)
    xt, mt, split, want = stages["C_f32_data_bf16x2_split"]
    np.testing.assert_array_equal(xt.numpy(), x)
    np.testing.assert_array_equal(mt.numpy(), m01)
    assert split and (kpp.SP, kpp.K, kpp.N) == (jprobe.SP, jprobe.K, jprobe.N)
    np.testing.assert_allclose(want, x.astype(np.float64) @ m01, rtol=1e-12)


def test_stage_a_plain_equals_interpret_single_pass(stages):
    sel, vals, split, _ = stages["A_select_bf16_single_pass"]
    ref = interpret(jprobe._kernel_single, jnp.asarray(sel.float().numpy(),
                                                       jnp.bfloat16),
                    jnp.asarray(vals.float().numpy(), jnp.bfloat16))
    out = kpp.precision_probe(sel, vals, split)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_stage_c_plain_equals_interpret_split(stages):
    x, m, split, _ = stages["C_f32_data_bf16x2_split"]
    ref = interpret(jprobe._kernel_split, jnp.asarray(x.numpy()),
                    jnp.asarray(m.numpy()))
    np.testing.assert_allclose(kpp.precision_probe(x, m, split).numpy(), ref,
                               rtol=1e-6, atol=1e-6)


def test_stage_b_plain_equals_the_bf16_product(stages):
    x, m, split, _ = stages["B_f32_data_single_pass_DEFAULT"]
    ref = np.asarray(jnp.dot(jnp.asarray(x.numpy(), jnp.bfloat16),
                             jnp.asarray(m.numpy(), jnp.bfloat16),
                             preferred_element_type=jnp.float32))
    out = kpp.precision_probe(x, m, split).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    # Interpret mode keeps f32: its single pass is not the bf16 product.
    f32 = interpret(jprobe._kernel_single, jnp.asarray(x.numpy()),
                    jnp.asarray(m.numpy()))
    assert np.abs(f32 - out).max() > 1e-3


def test_entry_point_on_the_cpu(capsys):
    assert kpp.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("backend: cpu")
    import json

    stages = [json.loads(line) for line in lines[1:]]
    assert [s["stage"] for s in stages] == list(kpp.probe_inputs())
    assert stages[0]["max_abs"] == 0.0
    assert stages[2]["mismatch_frac_contract"] == 0.0
    assert stages[1]["max_abs"] > 100 * stages[2]["max_abs"]
