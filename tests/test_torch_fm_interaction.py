"""Port parity of kernel B4's module: the FM pairwise interaction.

The same numpy inputs go through the JAX op (its Pallas kernel in
interpret mode) and the port's public op, whose wrapper runs the plain
version on the CPU.  Inputs are unit-normal, as ``tests/test_kernels.py``
holds the reference kernel, so the term does not vanish under the
cancellation of the sum-square identity; the tolerance is the
reference's 2e-4.  The CUDA kernel itself runs in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card; here its
launch plan and its C interface are checked.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fm_interaction import ops as jops
from repro.kernels.fm_interaction.ref import fm_interaction_ref as jref
from repro_torch.kernels.fm_interaction import kernel as K
from repro_torch.kernels.fm_interaction import ops
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

CSRC = pathlib.Path(K.__file__).resolve().parents[1] / "csrc"


def _v(b, f, k, seed=0):
    return np.random.RandomState(seed).normal(0, 1, (b, f, k)) \
        .astype(np.float32)


@pytest.mark.parametrize("b,f,k", [(8, 5, 4), (16, 39, 10), (64, 26, 16),
                                   (13, 39, 10), (1, 2, 1)])
def test_matches_jax_op_in_interpret_mode(b, f, k):
    v = _v(b, f, k)
    want = np.asarray(jops.fm_interaction(jnp.asarray(v), interpret=True))
    got = ops.fm_interaction(torch.from_numpy(v)).numpy()
    assert got.shape == (b,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(jref(jnp.asarray(v))),
                               rtol=2e-4, atol=2e-4)


def test_equals_naive_pairwise_sum():
    v = _v(4, 6, 3, seed=1)
    naive = sum((v[:, i] * v[:, j]).sum(-1)
                for i in range(6) for j in range(i + 1, 6))
    got = ops.fm_interaction(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, naive, rtol=1e-4, atol=1e-5)


def test_bf16_input_matches_jax_on_the_same_bf16_values():
    """Both upcast the same bf16 values and sum in fp32: the reference's
    2e-4 holds."""
    v = _v(16, 39, 10, seed=2)
    vj = jnp.asarray(v).astype(jnp.bfloat16)
    want = np.asarray(jops.fm_interaction(vj, interpret=True))
    vt = torch.from_numpy(v).to(torch.bfloat16)
    assert np.array_equal(np.asarray(vj.astype(jnp.float32)),
                          vt.float().numpy())
    got = ops.fm_interaction(vt).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    v = torch.from_numpy(_v(7, 39, 10))
    before = K.fm_interaction_kernel_call.launches
    assert torch.equal(ops.fm_interaction(v), fm_interaction_ref(v))
    assert K.fm_interaction_kernel_call.launches == before


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros(4, 10), ValueError),
    (torch.zeros(2, 4, 3, 2), ValueError),
    (torch.zeros(4, 3, 2, dtype=torch.float16), TypeError),
    (torch.zeros(4, 3, 2, dtype=torch.int32), TypeError),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad, exc):
    with pytest.raises(exc):
        ops.fm_interaction(bad)


@pytest.mark.parametrize("f,k", [(39, 10), (5, 4), (26, 16), (1, 1),
                                 (300, 32)])
def test_plan_fits_and_aligns(f, k):
    spb, smem = K.plan(f, k)
    assert 1 <= spb <= K.MAX_SAMPLES_PER_BLOCK
    assert smem == 4 * spb * (f * k + k) <= K.SMEM_BUDGET
    # the next multiple of 8 would not fit, or spb is capped
    if spb >= 8:
        assert spb % 8 == 0
        # every block's range of v starts 16-byte aligned in bf16 and fp32
        assert (spb * f * k * 2) % 16 == 0
    assert K.plan(39, 10) == (24, 38400)


def test_plan_raises_when_a_sample_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        K.plan(1000, 16)


def test_c_interface_matches_the_wrapper():
    """The launcher's arguments and shared-memory cap in the CUDA source
    agree with the ctypes signature and :data:`SMEM_BUDGET`."""
    src = (CSRC / "fm_interaction.cu").read_text()
    sig = re.search(r"int fm_interaction_launch\(([^)]*)\)", src).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert [p.split()[-1] for p in params] == [
        "v", "out", "batch", "f", "k", "spb", "bf16", "stream"]
    assert sum(p.startswith("int ") for p in params) == 5
    assert "kMaxSmem = 48 * 1024" in src and K.SMEM_BUDGET == 48 * 1024
    assert "kThreads = 256" in src
