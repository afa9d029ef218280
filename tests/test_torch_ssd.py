"""The port's SSD scan (``repro_torch.kernels.ssd``, plain version on the
CPU) and its ``models.ssm`` functions against the JAX package: the Pallas
kernel ``ssd_scan`` (interpret mode on the CPU, as ``tests/test_kernels.py``
runs it), the sequential oracle ``ssd_reference`` and ``ssd_chunked`` —
the latter with a ragged tail and an entering state, the contract the
port's wrapper takes beyond the Pallas kernel's.

Tolerance: 2e-3 (rtol and atol), the JAX kernel tests' gate: chunked and
sequential float32 scans sum decays in different orders over up to 512
steps.  Inputs are made from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_ref, ssd_scan
from repro.models import ssm as jssm
from repro_torch.kernels import ssd as port
from repro_torch.models import ssm

TOL = dict(rtol=2e-3, atol=2e-3)


def _inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(
        np.float32)
    A = -np.exp(rng.uniform(-1.0, 1.0, h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def _t(arrs):
    return [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 4, 64, 64, 128),
    (1, 128, 2, 32, 16, 32),
    (1, 512, 1, 64, 128, 128),
])
def test_ssd_matches_pallas_and_sequential(b, s, h, p, n, chunk):
    args = _inputs(s + h, b, s, h, p, n)
    y, st = port.ssd_scan(*_t(args), chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == (b, h, p, n)
    y_k, st_k = ssd_scan(*args, chunk=chunk)
    y_r, st_r = ssd_ref(*args)
    for want_y, want_st in ((y_k, st_k), (y_r, st_r)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **TOL)


@pytest.mark.parametrize("s,chunk", [(300, 256), (24, 24), (200, 64),
                                     (1, 16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_ragged_tail_and_initial_state_match_chunked(s, chunk,
                                                         with_state):
    """A tail shorter than a chunk (zero-padded, y cut back) and an
    entering state: the JAX ``ssd_chunked`` contract."""
    b, h, p, n = 2, 3, 16, 32
    args = _inputs(s + chunk, b, s, h, p, n)
    st0 = np.random.default_rng(s).standard_normal((b, h, p, n)).astype(
        np.float32) if with_state else None
    y, st = port.ssd_scan(*_t(args), chunk=chunk,
                          initial_state=None if st0 is None
                          else torch.as_tensor(st0))
    y_c, st_c = jssm.ssd_chunked(*args, chunk=chunk,
                                 initial_state=None if st0 is None
                                 else jnp.asarray(st0))
    assert y.shape == (b, s, h, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_c), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_c), **TOL)


def test_ssd_chunk_invariance():
    args = _t(_inputs(3, 1, 256, 2, 32, 32))
    y1, s1 = port.ssd_scan(*args, chunk=64)
    y2, s2 = port.ssd_scan(*args, chunk=256)
    torch.testing.assert_close(y1, y2, **TOL)
    torch.testing.assert_close(s1, s2, **TOL)


@pytest.mark.parametrize("fn", ["ssd_chunked", "ssd_reference"])
def test_model_ssd_functions_match_jax(fn):
    """``models.ssm.ssd_chunked`` and ``ssd_reference`` of the port
    against the JAX package's, ragged length and entering state."""
    b, s, h, p, n = 1, 100, 2, 16, 16
    args = _inputs(11, b, s, h, p, n)
    st0 = np.random.default_rng(2).standard_normal((b, h, p, n)).astype(
        np.float32)
    kw = {"chunk": 32} if fn == "ssd_chunked" else {}
    y, st = getattr(ssm, fn)(*_t(args), initial_state=torch.as_tensor(st0),
                             **kw)
    y_j, st_j = getattr(jssm, fn)(*args, initial_state=jnp.asarray(st0),
                                  **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), **TOL)


def test_ssd_step_matches_jax():
    b, h, p, n = 2, 3, 16, 8
    x, dt, A, B, C = _inputs(4, b, 1, h, p, n)
    st0 = np.random.default_rng(4).standard_normal((b, h, p, n)).astype(
        np.float32)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    st, y = ssm.ssd_step(torch.as_tensor(st0), *_t(args))
    st_j, y_j = jssm.ssd_step(jnp.asarray(st0), *args)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=1e-5,
                               atol=1e-5)


def test_ssd_bf16_inputs_close_to_f32():
    """bf16 x, B, C (the serve path's type): y in bf16 within bf16
    rounding of the float32 scan on the same (rounded) inputs."""
    args = _t(_inputs(8, 1, 96, 2, 16, 16))
    bf = [a.to(torch.bfloat16) if i in (0, 3, 4) else a
          for i, a in enumerate(args)]
    y, st = port.ssd_scan(*bf, chunk=32)
    y32, st32 = port.ssd_scan(*[a.float() for a in bf], chunk=32)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), y32, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(st, st32, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_ssd_tensor_core_counter_beside_the_launch_counter(device):
    """``MMA_LAUNCHES`` counts the card's calls that ran the tensor-core
    stages (bf16): it is listed in ``kernels.LAUNCH_COUNTERS`` (so a CUDA
    graph's replay adds to it), ``reset_launches`` zeroes it with
    ``LAUNCHES``, and a bf16 call on the CPU (the plain version) or on the
    meta device (shapes only) counts in neither."""
    from repro_torch import kernels
    assert any(c is port.MMA_LAUNCHES for c in kernels.LAUNCH_COUNTERS)
    port.LAUNCHES["ssd_scan"] += 2
    port.MMA_LAUNCHES["ssd_scan_mma"] += 1
    port.reset_launches()
    assert port.LAUNCHES == {"ssd_scan": 0}
    assert port.MMA_LAUNCHES == {"ssd_scan_mma": 0}
    args = [a.to(device) for a in _t(_inputs(2, 1, 40, 2, 16, 8))]
    bf = [a.to(torch.bfloat16) if i in (0, 3, 4) else a
          for i, a in enumerate(args)]
    y, st = port.ssd_scan(*bf, chunk=16)
    assert y.dtype == torch.bfloat16 and y.device.type == device
    assert port.LAUNCHES == {"ssd_scan": 0}
    assert port.MMA_LAUNCHES == {"ssd_scan_mma": 0}


def test_ssd_cpu_takes_plain_path_without_counting():
    args = _t(_inputs(1, 1, 16, 2, 16, 8))
    before = dict(port.LAUNCHES)
    port.ssd_scan(*args, chunk=8)
    assert port.LAUNCHES == before
    with pytest.raises(ValueError):
        port.ssd_scan(args[0], args[1][:, :8], *args[2:], chunk=8)
    with pytest.raises(ValueError):
        port.ssd_scan(*args, chunk=8,
                      initial_state=torch.zeros(1, 2, 16, 4))
