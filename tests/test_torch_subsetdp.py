"""The port's subset-DP kernel module against the JAX reference.

On the CPU the wrappers of ``repro_torch.kernels.subsetdp.ops`` take the
plain torch version (``ref.py``); it must be BIT-EXACT (``tobytes()``
equal) with the reference's Pallas kernel in interpret mode and with its
NumPy oracle ``repro.core.batched._subset_dp`` — the same ascending-index
IEEE operation chain, no tolerance.  The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).  Inputs are made from numpy seeds.
"""
import numpy as np
import pytest
import torch

from repro.core.batched import _subset_dp
from repro.kernels.subsetdp import subset_argmin as ref_subset_argmin
from repro.kernels.subsetdp import subset_dp as ref_subset_dp
from repro_torch.kernels.subsetdp import ops

CPU = torch.device("cpu")


def _instance(rng, n, b, ties=False):
    """(costs [n], rhos [b, n], M).  ``ties`` makes every cost equal, every
    rho row constant, and adds rho in {0, 1} rows — exact ties across
    whole subset sizes (the first view version's regime)."""
    if ties:
        costs = np.full(n, 2.0)
        rhos = np.repeat(rng.choice([0.0, 0.25, 0.5, 1.0], (b, 1)), n, 1)
    else:
        costs = rng.uniform(0.05, 5.0, n)
        rhos = rng.uniform(0.0, 1.0, (b, n))
        rhos[0] = 0.0
        rhos[1 % b] = 1.0
    return costs, rhos, float(rng.uniform(1.5, 1000.0))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", list(range(1, 11)))
def test_subset_dp_bit_exact_vs_pallas_and_oracle(n, ties):
    """Plain subset_prod + cost add == the Pallas kernel (interpret mode)
    == ``_subset_dp``, byte for byte, for n = 1..10 (B off every block
    size so the reference pads)."""
    rng = np.random.default_rng(300 + n + 50 * ties)
    b = 5 if n > 8 else 37
    costs, rhos, M = _instance(rng, n, b, ties)
    got = ops.subset_dp(costs, rhos, M, device="cpu").numpy()
    oracle = _subset_dp(costs, rhos, M)
    pallas = ref_subset_dp(costs, rhos, M, backend="pallas", interpret=True)
    assert got.shape == oracle.shape == (b, 1 << n)
    assert got.tobytes() == oracle.tobytes()
    assert got.tobytes() == pallas.tobytes()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", [1, 3, 6, 9])
def test_subset_argmin_matches_pallas(n, ties):
    """The winning subset per row, with and without the CS_FNO
    ``allowed`` restriction, equals the reference's on-device argmin
    over its Pallas products exactly (lowest mask among equal minima)."""
    rng = np.random.default_rng(400 + n + 50 * ties)
    b = 41
    costs, rhos, M = _instance(rng, n, b, ties)
    got = ops.subset_argmin(costs, rhos, M, device="cpu").numpy()
    want = ref_subset_argmin(costs, rhos, M, backend="pallas",
                             interpret=True)
    assert np.array_equal(got, want)
    allowed = rng.integers(0, 1 << n, b, dtype=np.int64)
    got = ops.subset_argmin(costs, rhos, M, allowed=allowed,
                            device="cpu").numpy()
    want = ref_subset_argmin(costs, rhos, M, allowed=allowed,
                             backend="pallas", interpret=True)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [2, 5, 8])
def test_subset_argmin_per_row_penalty_matches_oracle(n):
    """A [B] penalty vector (the cross-cell exhaustive prefetch) seeds
    each row's product: values equal ``_subset_dp`` with the same vector,
    and the argmin equals the oracle's first-minimum argmin."""
    rng = np.random.default_rng(500 + n)
    b = 29
    costs, rhos, _ = _instance(rng, n, b)
    mp = rng.uniform(1.5, 1000.0, b)
    phi = _subset_dp(costs, rhos, mp)
    got = ops.subset_dp(costs, rhos, mp, device="cpu").numpy()
    assert got.tobytes() == phi.tobytes()
    best = ops.subset_argmin(costs, rhos, mp, device="cpu").numpy()
    assert np.array_equal(best, np.argmin(phi, axis=1))


def test_subset_argmin_chunked_plain_version_is_chunk_invariant(monkeypatch):
    """The plain version bounds its working set by row chunks; chunk
    boundaries must not enter the result."""
    from repro_torch.kernels.subsetdp import ref
    rng = np.random.default_rng(600)
    costs, rhos, M = _instance(rng, 7, 53)
    whole = ops.subset_argmin(costs, rhos, M, device="cpu")
    monkeypatch.setattr(ref, "CHUNK_ELEMS", 5 * 128)
    assert torch.equal(ops.subset_argmin(costs, rhos, M, device="cpu"),
                       whole)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        ops.subset_argmin([1.0] * 17, np.zeros((2, 17)), 5.0, device="cpu")
    with pytest.raises(ValueError):
        ops.subset_prod(np.zeros((3, 2)), np.ones(2), device="cpu")
    with pytest.raises(ValueError):
        ops.subset_argmin([1.0, 1.0], np.zeros((3, 2)), 5.0,
                          allowed=np.zeros(2, np.int64), device="cpu")
