"""The port's torch-SGD step (bayesdll_tpu_torch.core.sgd) against the JAX
package's `sgd_step` and against torch.optim.SGD, on the same numpy inputs
(mirrors tests/test_sgd_parity.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesdll_tpu.core.sgd import sgd_step as j_sgd_step
from bayesdll_tpu_torch.core.sgd import sgd_step

STEPS, LR, DIM = 5, 0.1, 13


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    theta0 = rng.randn(DIM).astype(np.float32)
    grads = [rng.randn(DIM).astype(np.float32) for _ in range(STEPS)]
    return theta0, grads


def _port(theta0, grads, momentum, lr):
    theta = torch.from_numpy(theta0.copy())
    buf = torch.zeros(DIM)
    for i, g in enumerate(grads):
        out = sgd_step(theta, torch.from_numpy(g), buf, lr, momentum, i)
        assert out[0] is theta and out[1] is buf  # in place
    return theta.numpy(), buf.numpy()


@pytest.mark.parametrize("momentum", [0.0, 0.5, 0.9])
def test_matches_jax(momentum):
    theta0, grads = _inputs()
    theta, buf = jnp.asarray(theta0), jnp.zeros(DIM)
    lr_vec = jnp.full((DIM,), LR, jnp.float32)
    for i, g in enumerate(grads):
        theta, buf = j_sgd_step(theta, jnp.asarray(g), buf, lr_vec, momentum,
                                jnp.asarray(i))
    t_theta, t_buf = _port(theta0, grads, momentum,
                           torch.full((DIM,), LR, dtype=torch.float32))
    np.testing.assert_allclose(t_theta, np.asarray(theta), rtol=1e-6, atol=1e-7)
    if momentum:
        np.testing.assert_allclose(t_buf, np.asarray(buf), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("momentum", [0.0, 0.5, 0.9])
def test_matches_torch_optim_sgd(momentum):
    # includes torch's first step, buf = grad (a clone, not zero)
    theta0, grads = _inputs(seed=1)
    p = torch.nn.Parameter(torch.from_numpy(theta0.copy()))
    opt = torch.optim.SGD([p], lr=LR, momentum=momentum)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    t_theta, _ = _port(theta0, grads, momentum, LR)
    np.testing.assert_allclose(t_theta, p.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_first_step_clones_the_gradient():
    theta, buf = torch.zeros(4), torch.full((4,), 7.0)
    g = torch.arange(4, dtype=torch.float32)
    sgd_step(theta, g, buf, 0.5, 0.9, 0)
    assert torch.equal(buf, g) and buf.data_ptr() != g.data_ptr()
    g.add_(1.0)  # a later write to the gradient leaves buf alone
    assert torch.equal(buf, torch.arange(4, dtype=torch.float32))
    assert torch.equal(theta, -0.5 * buf)
