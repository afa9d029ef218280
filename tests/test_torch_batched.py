"""The port's batched table layer (``repro_torch.core.batched``) against
the JAX reference (``repro.core.batched``), on the CPU.

Checks and tolerances follow ``tests/test_jax_backend.py``:

  * DS_PGM masks (torch float64) equal the reference's jnp build EXACTLY
    except on rows flagged as near-tie dead-band — the two smallest
    prefix costs within 1e-9 relative of each other, where an ulp of
    ``log``/``exp`` may legitimately flip the argmin;
  * exhaustive (subset-DP) tables, the HOCS mirror and the NumPy host
    paths are exact, no dead-band.

Inputs are made from numpy seeds; both sides get the same arrays.
"""
import numpy as np
import pytest
import torch

import repro.core.batched as rb
import repro_torch.core.batched as tb

CPU = torch.device("cpu")


def _views(rng, v, n, ties=False):
    pi = rng.uniform(0.0, 1.0, (v, n))
    nu = rng.uniform(0.0, 1.0, (v, n))
    if ties:            # the first view version: every cache looks alike
        pi[0] = pi[0, 0]
        nu[0] = nu[0, 0]
    return pi, nu


def _near_tie_rows(costs_cells, pi, nu, penalties, fno_cells, margin=1e-9):
    """[C, V*K] bool: rows whose two best DS_PGM prefix values lie within
    ``margin`` (relative) of each other."""
    v, n = pi.shape
    k = 1 << n
    pats = ((np.arange(k)[:, None] >> np.arange(n)[None, :]) & 1)
    rhos = np.where(pats[None, :, :] > 0,
                    pi[:, None, :], nu[:, None, :]).reshape(v * k, n)
    allowed = np.tile(pats, (v, 1)) > 0
    out = np.zeros((len(costs_cells), v * k), bool)
    for ci, (costs, M, fno) in enumerate(zip(costs_cells, penalties,
                                             fno_cells)):
        r = np.clip(rhos, rb.EPS, 1.0 - rb.EPS)
        key = costs[None, :] / -np.log(r)
        c_b = np.broadcast_to(costs, r.shape)
        if fno:
            key = np.where(allowed, key, np.inf)
            c_b = np.where(allowed, c_b, np.inf)
            r = np.where(allowed, r, 1.0)
        order = np.argsort(key, axis=1, kind="stable")
        csum = np.cumsum(np.take_along_axis(c_b, order, 1), axis=1)
        lprod = np.cumsum(np.log(np.take_along_axis(r, order, 1)), axis=1)
        phi = np.concatenate(
            [np.full((v * k, 1), M), csum + M * np.exp(lprod)], axis=1)
        two = np.sort(phi, axis=1)[:, :2]
        out[ci] = (two[:, 1] - two[:, 0]) <= margin * np.maximum(
            np.abs(two[:, 0]), 1.0)
    return out


def _assert_masks_agree(got, want, ties):
    diff = (got != want).any(axis=-1).reshape(ties.shape)
    assert not np.any(diff & ~ties), \
        f"{int((diff & ~ties).sum())} rows differ outside the dead-band"


@pytest.mark.parametrize("fno", [False, True])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_selection_tables_match_reference(n, fno):
    rng = np.random.default_rng(20 + n + 10 * fno)
    v = 7
    pi, nu = _views(rng, v, n, ties=True)
    costs = rng.uniform(0.05, 5.0, n)
    M = 137.0
    want = rb.selection_tables(costs, pi, nu, M, fno=fno, backend="jax")
    got = tb.selection_tables(costs, pi, nu, M, fno=fno, device=CPU)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
    _assert_masks_agree(got.numpy(), want,
                        _near_tie_rows([costs], pi, nu, [M], [fno]))
    # the NumPy host path is a copy: exact
    np_got = tb.selection_tables(costs, pi, nu, M, fno=fno,
                                 backend="numpy")
    assert np.array_equal(
        np_got, rb.selection_tables(costs, pi, nu, M, fno=fno,
                                    backend="numpy"))


@pytest.mark.parametrize("ref_fn", ["selection_tables_cells",
                                    "selection_tables_cells_jax"])
def test_selection_tables_cells_match_reference(ref_fn):
    """The two-stage stacked build against both reference builds: the
    eager per-row stack and the jitted grouped kernel."""
    rng = np.random.default_rng(11)
    n, v, c = 4, 6, 9
    pi, nu = _views(rng, v, n, ties=True)
    costs_cells = rng.uniform(0.05, 5.0, (c, n))
    costs_cells[3] = costs_cells[0]          # shared (costs, fno) groups
    costs_cells[5] = costs_cells[1]
    penalties = rng.uniform(5.0, 500.0, c)
    fno_cells = (np.arange(c) % 2).astype(bool)
    want = getattr(rb, ref_fn)(costs_cells, pi, nu, penalties, fno_cells)
    got = tb.selection_tables_cells(costs_cells, pi, nu, penalties,
                                    fno_cells, device=CPU)
    assert tuple(got.shape) == want.shape == (c, v, 1 << n, n)
    _assert_masks_agree(got.numpy(), want, _near_tie_rows(
        costs_cells, pi, nu, penalties, fno_cells))
    # every cell's slice equals its own single-cell build
    for ci in range(c):
        one = tb.selection_tables(costs_cells[ci], pi, nu, penalties[ci],
                                  fno=bool(fno_cells[ci]), device=CPU)
        assert torch.equal(got[ci], one)


def test_selection_tables_cells_empty():
    pi, nu = _views(np.random.default_rng(12), 4, 3)
    got = tb.selection_tables_cells(np.empty((0, 3)), pi, nu, np.empty(0),
                                    np.empty(0, bool), device=CPU)
    assert tuple(got.shape) == (0, 4, 8, 3)


def test_ds_pgm_batched_equal_keys_keep_index_order():
    """Equal potential-gain keys (equal costs and rhos) must sort stably,
    like ``jnp.argsort``: the lowest-index caches form the prefix."""
    costs = np.full(5, 2.0)
    rhos = np.full((3, 5), 0.3)
    rhos[1, 3] = 0.9
    got = tb.ds_pgm_batched(torch.as_tensor(costs), torch.as_tensor(rhos),
                            60.0).numpy()
    import jax.numpy as jnp
    from jax.experimental import enable_x64
    with enable_x64():
        want = np.asarray(rb.ds_pgm_batched(jnp.asarray(costs),
                                            jnp.asarray(rhos), 60.0))
    assert np.array_equal(got, want)
    assert got[0].tolist() == [True, True, True, False, False]


def test_left_cumsum_is_sequential():
    x = np.random.default_rng(13).uniform(-1e3, 1e3, (50, 12))
    got = tb._left_cumsum(torch.as_tensor(x)).numpy()
    assert got.tobytes() == np.cumsum(x, axis=1).tobytes()


@pytest.mark.parametrize("fno", [False, True])
@pytest.mark.parametrize("n", [1, 4, 8, 10])
def test_exhaustive_tables_match_reference(n, fno):
    rng = np.random.default_rng(30 + n + 10 * fno)
    v = 2 if n >= 8 else 5
    pi, nu = _views(rng, v, n, ties=True)
    costs = rng.uniform(0.05, 5.0, n)
    M = 250.0
    want = rb.exhaustive_tables(costs, pi, nu, M, fno=fno)
    got = tb.exhaustive_tables(costs, pi, nu, M, fno=fno, device=CPU)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("fno", [False, True])
def test_exhaustive_tables_cells_match_reference(fno):
    """Per-row penalties reach the subset-DP as a [rows] vector; every
    cell equals the reference's stacked build and its own single build."""
    rng = np.random.default_rng(40 + fno)
    n, v = 5, 4
    pi, nu = _views(rng, v, n, ties=True)
    costs = rng.uniform(0.05, 5.0, n)
    penalties = [25.0, 100.0, 1000.0]
    want = rb.exhaustive_tables_cells(costs, pi, nu, penalties, fno=fno)
    got = tb.exhaustive_tables_cells(costs, pi, nu, penalties, fno=fno,
                                     device=CPU)
    assert np.array_equal(got.numpy(), want)
    for ci, M in enumerate(penalties):
        assert np.array_equal(
            got[ci].numpy(), rb.exhaustive_tables(costs, pi, nu, M, fno=fno))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_rho_exhaustive_tables_match_reference(backend):
    rng = np.random.default_rng(50)
    n, b = 6, 43
    costs = rng.uniform(0.05, 5.0, n)
    rhos = rng.uniform(0.0, 1.0, (b, n))
    allowed = rng.integers(0, 1 << n, b, dtype=np.int64)
    mp = rng.uniform(2.0, 800.0, b)
    for kw in (dict(), dict(allowed=allowed)):
        for pen in (300.0, mp):
            want = rb.rho_exhaustive_tables(costs, rhos, pen, **kw)
            got = tb.rho_exhaustive_tables(costs, rhos, pen, backend=backend,
                                           device=CPU, **kw)
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            assert np.array_equal(got, want)


def test_rho_selection_tables_and_subset_dp_copies_exact():
    rng = np.random.default_rng(60)
    n, b = 5, 64
    costs = rng.uniform(0.05, 5.0, n)
    rhos = rng.uniform(0.0, 1.0, (b, n))
    allowed = rng.random((b, n)) < 0.5
    for kw in (dict(), dict(allowed=allowed)):
        assert np.array_equal(tb.rho_selection_tables(costs, rhos, 80.0, **kw),
                              rb.rho_selection_tables(costs, rhos, 80.0, **kw))
    assert tb._subset_dp(costs, rhos, 80.0).tobytes() == \
        rb._subset_dp(costs, rhos, 80.0).tobytes()


@pytest.mark.parametrize("n", [2, 5, 7])
def test_hocs_tables_match_reference(n):
    rng = np.random.default_rng(70 + n)
    pi, nu = _views(rng, 6, n, ties=True)
    penalties = [3.0, 40.0, 900.0]
    assert np.array_equal(tb.hocs_selection_tables_cells(pi, nu, penalties),
                          rb.hocs_selection_tables_cells(pi, nu, penalties))
    assert np.array_equal(tb.hocs_selection_tables(pi, nu, 40.0),
                          rb.hocs_selection_tables(pi, nu, 40.0))
    nx = rng.integers(0, n + 1, 50)
    for got, want in zip(tb.hocs_fna_batched(nx, n, pi[0, 0], nu[:, 0].mean(),
                                             120.0),
                         rb.hocs_fna_batched(nx, n, pi[0, 0], nu[:, 0].mean(),
                                             120.0)):
        assert np.array_equal(got, want)


def test_masks_to_bits():
    mask = torch.tensor([[True, False, True], [False, False, False]])
    assert tb.masks_to_bits(mask).tolist() == [5, 0]
