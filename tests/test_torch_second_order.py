"""Why the port refuses AdaHessian through its kernels on the card
(ROADMAP A19, `advmil_tpu_torch/config.py::_not_ported`): the JAX package
has no second derivative through its Pallas kernels either.

AdaHessian's Hutchinson estimate is `jax.jvp` over `jax.grad`
(`advmil_tpu/train/optim.py::adahessian_grads`). Through the LN-pool kernel
(`advmil_tpu/ops/ln_pool.py::ln_relu_region_mean`, run as
`tests/test_ln_pool.py` runs it on the CPU, under
`pltpu.force_tpu_interpret_mode()`) and through the kNN aggregation kernel
(`advmil_tpu/ops/segment.py::fused_knn_softmax_aggregate`, a `custom_vjp`
with no JVP rule) that estimate raises; through their jnp references it is
finite. So on the TPU, `opt_net: adahessian` fails wherever a kernel is on
the path, as the port's `first_order` backwards do (the card test
`test_second_order_step_through_patch_kernels_raises`), and the port's
refusal names that reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advmil_tpu.ops.attention import _HAS_PALLAS
from advmil_tpu_torch import config as tconfig

if not _HAS_PALLAS:
    pytest.skip("pallas unavailable", allow_module_level=True)

from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from advmil_tpu.ops import ln_pool as jln  # noqa: E402
from advmil_tpu.ops import segment as jseg  # noqa: E402


def _problem(kernel, rng):
    """(kernel loss, reference loss, input) of one kernel at a small shape."""
    if kernel == "ln_relu_region_mean":
        M, D = 256, 128
        x = jnp.asarray(rng.normal(size=(M, D)), jnp.float32)
        scale = jnp.asarray(1.0 + rng.normal(0, 0.1, size=D), jnp.float32)
        bias = jnp.asarray(rng.normal(0, 0.1, size=D), jnp.float32)
        g = jnp.asarray(rng.normal(size=(M // 16, D)), jnp.float32)
        return (lambda h: jnp.sum(jln.ln_relu_region_mean(h, scale, bias) * g),
                lambda h: jnp.sum(jln.reference_ln_relu_region_mean(h, scale, bias) * g), x)
    N, epn, C = 64, 9, 32
    x = jnp.asarray(rng.normal(size=(N, epn, C)), jnp.float32)
    em = jnp.asarray((rng.random((N, epn)) > 0.2).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(N, C)), jnp.float32)
    t = jnp.float32(1.3)
    return (lambda m: jnp.sum(jseg.fused_knn_softmax_aggregate(m, em, t) * w),
            lambda m: jnp.sum(jseg.knn_edge_softmax_aggregate(m, em, t) * w), x)


@pytest.mark.parametrize("kernel", ["ln_relu_region_mean", "fused_knn_softmax_aggregate"])
def test_jax_kernels_have_no_second_derivative(kernel):
    """The Hessian-vector product `jax.jvp(jax.grad(f))` raises through the
    kernel (interpret mode) and is finite through its jnp reference (the
    kernels' first derivatives are held to the references in
    tests/test_ln_pool.py and tests/test_torch_graph.py)."""
    rng = np.random.default_rng(19)
    f_kernel, f_ref, x = _problem(kernel, rng)
    z = jnp.asarray(np.where(rng.random(x.shape) < 0.5, -1.0, 1.0), jnp.float32)
    _, hz = jax.jit(lambda x, z: jax.jvp(jax.grad(f_ref), (x,), (z,)))(x, z)
    assert np.all(np.isfinite(np.asarray(hz))) and float(jnp.abs(hz).max()) > 0
    with pltpu.force_tpu_interpret_mode():
        with pytest.raises((TypeError, ValueError, AssertionError, NotImplementedError)):
            jax.jvp(jax.grad(f_kernel), (x,), (z,))


def test_port_refusal_names_the_reason():
    """The port's refusal keeps its item and key, and gives the reason: the
    JAX package has no second derivative through its kernels either."""
    cfg = tconfig.with_defaults({"task": "surv_nll", "opt_net": "adahessian",
                                 "device": "cuda", "bcb_mode": "patch"})
    with pytest.raises(NotImplementedError) as err:
        tconfig.check_configs(cfg, "base")
    msg = str(err.value)
    for word in ("A19", "adahessian", "JAX package", "device: cpu runs it"):
        assert word in msg, msg
    assert "not ported yet" not in msg
