"""The port's flash attention (``repro_torch.kernels.flash_attention``,
plain version on the CPU) against the JAX package's Pallas kernel (run in
interpret mode on the CPU, as ``tests/test_kernels.py`` runs it) and its
oracle ``attention_ref``.

Tolerances: 2e-5 (rtol and atol) in float32, the JAX kernel tests' own
gate — both sides compute in float32 and differ only in summation order
(the Pallas kernel folds 128-key blocks with an online softmax, the
plain version takes each row's softmax at once).  bf16: 3e-2 against
the float32 oracle, as ``test_flash_attention_bf16``; and against the
Pallas kernel in bf16, where both keep p in float32 for the PV product
and round only o, so they differ by at most one bf16 ulp
(``2**-9 + 2**-8 |o|``) in at most 1% of the outputs.  Inputs are made
from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels import flash_attention as port
from repro_torch.models import layers

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b, sq, hq, hkv, d, sk=None):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]


def _port(q, k, v, causal, dtype=torch.float32):
    out = port.flash_attention(*[torch.as_tensor(a).to(dtype)
                                 for a in (q, k, v)], causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (2, 256, 4, 2, 64),
    (1, 512, 8, 8, 64),
    (2, 256, 4, 1, 128),
    (1, 384, 6, 3, 64),
    (1, 256, 4, 4, 112),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_and_oracle(b, s, hq, hkv, d, causal):
    q, k, v = _qkv(b * 100 + s + d, b, s, hq, hkv, d)
    got = _port(q, k, v, causal)
    pallas = np.asarray(flash_attention(q, k, v, causal=causal))
    oracle = np.asarray(attention_ref(q, k, v, causal=causal))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("s,hq,hkv,d", [(24, 9, 3, 64), (300, 4, 2, 16),
                                        (1, 2, 1, 32), (37, 6, 6, 128),
                                        (77, 4, 2, 112)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged_lengths_match_oracle(s, hq, hkv, d, causal):
    """Any sequence length (the serve path prefills 24 tokens; the
    Pallas wrapper's s % block_q == 0 rule does not apply)."""
    q, k, v = _qkv(s + hq, 1, s, hq, hkv, d)
    oracle = np.asarray(attention_ref(q, k, v, causal=causal))
    np.testing.assert_allclose(_port(q, k, v, causal), oracle, **TOL)


def test_flash_non_causal_cross_lengths():
    """Non-causal with Sk != Sq against the oracle."""
    q, k, v = _qkv(5, 2, 40, 4, 2, 32, sk=75)
    oracle = np.asarray(attention_ref(q, k, v, causal=False))
    np.testing.assert_allclose(_port(q, k, v, False), oracle, **TOL)


@pytest.mark.parametrize("sq,sk,d", [(40, 75, 32), (75, 40, 32),
                                     (48, 80, 112), (80, 48, 112)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_cross_lengths_and_head_dim_112(sq, sk, d, causal):
    """Sk != Sq against the oracle, at head dim 32 and at zamba2-7b's 112:
    non-causal (the encoder-decoder's cross attention), and causal with
    the reference's top-left mask (query i sees keys j <= i,
    ``flash.py:43-57``)."""
    q, k, v = _qkv(5 + d, 2, sq, 4, 2, d, sk=sk)
    oracle = np.asarray(attention_ref(q, k, v, causal=causal))
    np.testing.assert_allclose(_port(q, k, v, causal), oracle, **TOL)


def test_flash_bf16_close_to_f32_oracle():
    q, k, v = _qkv(7, 1, 256, 4, 2, 64)
    oracle = np.asarray(attention_ref(q, k, v, causal=True))
    got = _port(q, k, v, True, torch.bfloat16)
    np.testing.assert_allclose(got, oracle, rtol=3e-2, atol=3e-2)


def _bf16(a):
    """a rounded to bf16 values, kept as float32 (exact in both libraries)."""
    return torch.as_tensor(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("s,hq,hkv,d,block", [(256, 6, 2, 64, 128),
                                              (300, 6, 2, 64, 100)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_matches_pallas_bf16(s, hq, hkv, d, block, causal):
    """bf16 q, k, v through the Pallas kernel and the port's plain
    version: the PV product takes p in float32 on both sides (the Pallas
    kernel casts v to float32, so ``p.astype(v.dtype)`` keeps p in
    float32), so they agree to one bf16 ulp in all but a few outputs.
    Rounding p to bf16 before PV makes about a third of them differ."""
    q, k, v = (_bf16(a) for a in _qkv(s + hq + d, 1, s, hq, hkv, d))
    pallas = np.asarray(flash_attention(
        *(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)),
        causal=causal, block_q=block, block_k=block)).astype(np.float32)
    got = _port(q, k, v, causal, torch.bfloat16)
    diff = np.abs(got - pallas)
    assert np.all(diff <= 2.0 ** -9 + 2.0 ** -8 * np.abs(pallas)), \
        float(diff.max())
    assert np.count_nonzero(diff) <= 0.01 * diff.size, \
        np.count_nonzero(diff) / diff.size


def test_flash_equals_port_naive_attention():
    """The kernel's plain version and the model's own plain attention
    (``layers.attention_naive``, the decode-side arithmetic) agree."""
    q, k, v = [torch.as_tensor(a) for a in _qkv(9, 2, 48, 6, 2, 16)]
    a = port.flash_attention(q, k, v, causal=True)
    b = layers.attention_naive(q, k, v, causal=True)
    torch.testing.assert_close(a, b, **TOL)


def test_flash_cpu_takes_plain_path_without_counting():
    q, k, v = [torch.as_tensor(a) for a in _qkv(1, 1, 8, 2, 1, 16)]
    before = dict(port.LAUNCHES)
    port.flash_attention(q, k, v)
    assert port.LAUNCHES == before
    with pytest.raises(ValueError):
        port.flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError):
        port.flash_attention(q[:, :, :1], k[:, :, :1].expand(1, 8, 2, 16),
                             v)
