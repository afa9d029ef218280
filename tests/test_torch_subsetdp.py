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


# ---------------------------------------------------------------------------
# A NumPy model of the CUDA kernel's order of operations (csrc/subsetdp.cu):
# one multiply per mask, each product taken from its parent's (the mask
# without its highest bit), masks visited out of ascending order and
# compared lexicographically on (value, mask).  n <= 8: a row per thread,
# the low n - 3 bits walked depth first, each node owning a group of 2^3
# top-bit masks compared strictly in ascending order (with ``allowed``: a
# loop over the top patterns, one mask a node, each from the node's product
# times the pattern's rho values); n > 8: a warp per row, lane l owning
# the masks with low five bits l, its high bits walked depth first, the 32
# lanes' bests reduced lexicographically.
# ---------------------------------------------------------------------------

def _lexi_better(v, m, bv, bm):
    return (v < bv) | ((v == bv) & (m < bm))


def _model_rows(cost, rhos, M, allowed):
    b, n = rhos.shape
    H = min(3, n)
    L = n - H
    if allowed is None:                   # groups of 2^H ascending masks
        def group(M_, p):
            q = {0: p}
            gv = cost[M_] + p
            gm = np.full(b, M_, np.int64)
            for s in range(1, 1 << H):
                hb = s.bit_length() - 1
                q[s] = q[s ^ (1 << hb)] * rhos[:, L + hb]
                phi = cost[M_ | (s << L)] + q[s]
                take = phi < gv
                gv = np.where(take, phi, gv)
                gm = np.where(take, M_ | (s << L), gm)
            return gv, gm

        best_v, best_m = group(0, np.full(b, M, np.float64))

        def walk(B, M_, p):
            nonlocal best_v, best_m
            if B >= L:
                return
            MC = M_ | (1 << B)
            q = p * rhos[:, B]
            gv, gm = group(MC, q)
            take = _lexi_better(gv, gm, best_v, best_m)
            best_v = np.where(take, gv, best_v)
            best_m = np.where(take, gm, best_m)
            walk(B + 1, MC, q)
            walk(B + 1, M_, p)

        walk(0, 0, np.full(b, M, np.float64))
        return best_m
    # with allowed: a loop over the top patterns s, one mask a low node
    best_v = np.full(b, np.inf)
    best_m = np.full(b, 1 << n, np.int64)
    for s in range(1 << H):
        ok_s = (s & ~((allowed >> L) & ((1 << H) - 1))) == 0

        def visit(M_, p, ok):
            nonlocal best_v, best_m
            for j in range(H):
                if (s >> j) & 1:
                    p = p * rhos[:, L + j]
            m = M_ | (s << L)
            phi = cost[m] + p
            take = ok & _lexi_better(phi, m, best_v, best_m)
            best_v = np.where(take, phi, best_v)
            best_m = np.where(take, m, best_m)

        def walk(B, M_, p, ok):
            if B >= L:
                return
            MC = M_ | (1 << B)
            q = p * rhos[:, B]
            a = ok & (((allowed >> B) & 1) == 1)
            visit(MC, q, a)
            walk(B + 1, MC, q, a)
            walk(B + 1, M_, p, ok)

        root = np.full(b, M, np.float64)
        visit(0, root, ok_s)
        walk(0, 0, root, ok_s)
    return best_m


def _model_warp(cost, rhos, M, allowed):
    b, n = rhos.shape
    al = np.full(b, -1, np.int64) if allowed is None else allowed
    lanes_v, lanes_m = [], []
    for lane in range(32):
        p = np.full(b, M, np.float64)
        for j in range(5):
            if (lane >> j) & 1:
                p = p * rhos[:, j]
        alive = (lane & ~al) == 0
        bv = np.where(alive, cost[lane] + p, np.inf)
        bm = np.where(alive, lane, 1 << n).astype(np.int64)

        def walk(start, m, p, live):
            nonlocal bv, bm
            for bit in range(start, n):
                ok = live & (((al >> bit) & 1) == 1)
                q = p * rhos[:, bit]
                mc = m | (1 << bit)
                phi = cost[mc] + q
                take = ok & _lexi_better(phi, mc, bv, bm)
                bv = np.where(take, phi, bv)
                bm = np.where(take, mc, bm)
                walk(bit + 1, mc, q, ok)

        walk(5, lane, p, alive)
        lanes_v.append(bv)
        lanes_m.append(bm)
    v, m = np.stack(lanes_v), np.stack(lanes_m)
    best_v, best_m = v[0], m[0]
    for lane in range(1, 32):
        take = _lexi_better(v[lane], m[lane], best_v, best_m)
        best_v = np.where(take, v[lane], best_v)
        best_m = np.where(take, m[lane], best_m)
    return best_m


def _tie_rows(rng, n, b):
    """Rows of 0, 1 and 0.5 rhos (exact ties across subset sizes) among
    random ones, with costs that tie whole subset sizes."""
    costs = np.where(rng.random(n) < 0.5, 2.0, rng.uniform(0.05, 5.0, n))
    rhos = rng.uniform(0.0, 1.0, (b, n))
    for i, val in ((0, 0.0), (1, 1.0), (2, 0.5), (7, 0.5), (31, 1.0),
                   (32, 0.0), (40, 0.5)):
        rhos[i % b] = val
    return costs, rhos, float(rng.choice([2.0, 100.0, 3.5]))


@pytest.mark.parametrize("with_allowed", [False, True])
@pytest.mark.parametrize("n", list(range(1, 13)))
def test_kernel_walk_model_matches_subset_dp_argmin(n, with_allowed):
    """The kernel's walk (modelled in NumPy, IEEE float64 like the card's
    ``_rn`` operations) picks ``_subset_dp``'s first minimum bit for bit,
    on rows where exact ties abound, for both the row-per-thread (n <= 8)
    and the warp-per-row (n > 8) orders."""
    rng = np.random.default_rng(900 + n + 20 * with_allowed)
    b = 48
    costs, rhos, M = _tie_rows(rng, n, b)
    allowed = None
    if with_allowed:
        allowed = rng.integers(0, 1 << n, b, dtype=np.int64)
        allowed[:3] = [0, (1 << n) - 1, (1 << n) - 1]
    phi = _subset_dp(costs, rhos, M)
    if allowed is not None:
        phi[(np.arange(1 << n)[None, :] & ~allowed[:, None]) != 0] = np.inf
    want = np.argmin(phi, axis=1)
    cost = ops.subset_costs(costs, n, "cpu").numpy()
    model = _model_rows if n <= ops.UNROLL_MAX_N else _model_warp
    got = model(cost, rhos, M, allowed)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(ops.subset_argmin(costs, rhos, M, allowed=allowed,
                                            device="cpu").numpy(), want)
