"""The port's ``("cells",)`` sweep mesh and the mesh launcher on the CPU,
in spawned gloo process worlds.

  * ``selection_tables_cells(mesh=)`` on worlds of 2 and 3 ranks (3 pads
    the group and cell axes) bit-equal to ``mesh=None``;
  * ``run_grid(mesh=)`` of the ``fig3_penalty`` golden scenario (a penalty
    axis: one stacked DS_PGM build, its cells sharded) equal to its
    ``tests/golden`` file on every rank;
  * ``launch.train --mesh elastic --model-dim 2`` under
    ``torch.distributed.run`` against ``--mesh none``, and its ``--resume``
    at ``--model-dim 1`` continuing from its checkpoint.

Each world meets at a ``FileStore`` under the test's temporary directory
and has a deadline of its own (``repro_torch.launch.mesh.run_world``);
``torch.distributed.run --standalone`` picks a free port itself.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
WORLD_TIMEOUT = 120


def _world(fn, world, tmp_path, *args):
    from repro_torch.launch.mesh import run_world
    run_world(fn, world, tmp_path / f"store_{fn.__name__}_{world}",
              args=args, device="cpu", timeout=WORLD_TIMEOUT)


def _tables_inputs():
    rng = np.random.default_rng(7)
    v, n = 3, 4
    pi = rng.uniform(0.05, 0.9, (v, n))
    nu = rng.uniform(0.0, 0.3, (v, n))
    costs = [(1.0, 2.0, 3.0, 4.0), (2.0, 2.0, 1.0, 5.0), (1.0, 2.0, 3.0, 4.0),
             (3.0, 1.0, 1.0, 1.0), (1.0, 2.0, 3.0, 4.0)]
    penalties = [10.0, 25.0, 100.0, 40.0, 1000.0]
    fno = [False, True, True, False, False]
    return costs, pi, nu, penalties, fno


def _tables_world(rank, world, out_dir):
    from repro_torch.core.batched import selection_tables_cells
    from repro_torch.launch.mesh import make_sweep_mesh
    costs, pi, nu, penalties, fno = _tables_inputs()
    mesh = make_sweep_mesh()
    got = selection_tables_cells(costs, pi, nu, penalties, fno,
                                 device="cpu", mesh=mesh)
    want = selection_tables_cells(costs, pi, nu, penalties, fno,
                                  device="cpu")
    torch.save({"mesh": tuple(mesh.shape), "equal": torch.equal(got, want),
                "shape": tuple(got.shape)},
               Path(out_dir) / f"tables_{world}_{rank}.pt")


def _golden_world(rank, world, out_dir):
    import dataclasses

    from repro_torch.cachesim import get_scenario, run_grid
    from repro_torch.cachesim.sweep import hashable_label
    from repro_torch.core import batched
    from repro_torch.launch.mesh import make_sweep_mesh
    calls = []
    sharded = batched._cells_sharded

    def counted(*a, **k):
        calls.append(1)
        return sharded(*a, **k)
    batched._cells_sharded = counted
    sc = get_scenario("fig3_penalty")
    traces, values = sc.golden_grid()
    grid = run_grid(traces, sc.config(**sc.golden_base), sc.axis, values,
                    policies=sc.policies, device="cpu",
                    mesh=make_sweep_mesh())
    payload = json.loads((GOLDEN / "fig3_penalty.json").read_text())
    bad = []
    for cell in payload["cells"]:
        res = grid[(cell["trace"], hashable_label(cell["label"]))][
            cell["policy"]]
        for f, want in cell["result"].items():
            got = getattr(res, f)
            if (list(got) if isinstance(got, tuple) else got) != want:
                bad.append((cell["trace"], cell["label"], cell["policy"], f))
    n_fields = len(dataclasses.fields(res))
    torch.save({"bad": bad, "cells": len(payload["cells"]),
                "sharded_calls": len(calls), "fields": n_fields},
               Path(out_dir) / f"golden_{world}_{rank}.pt")


@pytest.mark.parametrize("world", [2, 3])
def test_cells_sharded_tables_bit_equal(tmp_path, world):
    _world(_tables_world, world, tmp_path, str(tmp_path))
    for r in range(world):
        res = torch.load(tmp_path / f"tables_{world}_{r}.pt")
        assert res["mesh"] == (world,)
        assert res["shape"] == (5, 3, 16, 4)
        assert res["equal"], f"rank {r}"


def test_run_grid_on_sweep_mesh_matches_golden(tmp_path):
    _world(_golden_world, 2, tmp_path, str(tmp_path))
    for r in range(2):
        res = torch.load(tmp_path / f"golden_{2}_{r}.pt")
        assert res["cells"] > 0 and res["bad"] == [], f"rank {r}"
        assert res["sharded_calls"] >= 1


# --------------------------------------------------------------------------
# the launcher under torch.distributed.run
# --------------------------------------------------------------------------

TRAIN = ["-m", "repro_torch.launch.train", "--arch", "smollm-135m",
         "--reduced", "--device", "cpu", "--batch", "2", "--seq", "32",
         "--log-every", "1"]


def _run(args, nproc=None, rc=0):
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    cmd = [sys.executable]
    if nproc is not None:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(nproc)]
    r = subprocess.run(cmd + TRAIN + args, cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=WORLD_TIMEOUT)
    assert (r.returncode == 0) == (rc == 0), \
        r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout, r.stderr


def _losses(out):
    """{step: loss} of the ``[train] step`` lines."""
    return {int(line.split()[2]): float(line.split()[4])
            for line in out.splitlines() if line.startswith("[train] step ")}


def test_launcher_elastic_torchrun_matches_none_and_resumes(tmp_path):
    ref, _ = _run(["--steps", "5"])
    ck = str(tmp_path / "ck")
    # two ranks, model dim 2, preempted at step 3: the ranks checkpoint
    # and return 42
    out, err = _run(["--steps", "5", "--mesh", "elastic", "--model-dim",
                     "2", "--ckpt-dir", ck, "--kill-at", "3"], nproc=2, rc=1)
    assert "[train] elastic mesh: {'data': 1, 'model': 2}" in out
    assert "[train] preempted at step 3" in out
    # the first rank's 42 ends the run: the agent stops the other rank,
    # whose checkpoint write finished before the ranks' last barrier
    assert "exitcode  : 42" in err
    got, want = _losses(out), _losses(ref)
    assert sorted(got) == [0, 1, 2]           # rank 0 alone prints them
    for step, loss in got.items():
        assert abs(loss - want[step]) <= 1e-4, step
    assert (tmp_path / "ck" / "step_3" / "manifest.json").exists()
    # resumed on a world of one rank at model dim 1, onto the new mesh
    out, _ = _run(["--steps", "5", "--mesh", "elastic", "--model-dim", "1",
                   "--ckpt-dir", ck, "--resume"], nproc=1)
    assert "[train] resumed from step 3" in out
    res = json.loads(out.split("[train] summary ", 1)[1].splitlines()[0])
    assert res["mesh"] == {"data": 1, "model": 1}
    ref_sum = json.loads(ref.split("[train] summary ", 1)[1].splitlines()[0])
    np.testing.assert_allclose(res["losses"], ref_sum["losses"][3:],
                               rtol=1e-4)
