"""The port's data pipeline, checkpoints, fault-tolerance pieces and
training launcher, on the CPU.

  * ``SyntheticLMData.batch_at`` equals the JAX package's
    (``repro.data``) byte for byte, for every family's extras
    (``patch_embeds`` for vlm, ``frames`` for encdec);
  * the ``Prefetcher`` yields the synchronous stream and passes on its
    producer's exception;
  * ``tests/test_checkpoint.py``'s six cases on the port's module, a
    bfloat16 round trip (stored as its uint16 bit pattern) and the
    ``::``-joined leaf names of the JAX package's layout;
  * ``StepTimer`` and ``PreemptionHandler`` as ``tests/test_ft.py`` checks
    them, the handler also through a real signal;
  * the launcher's drill: a reference run, a run killed at step 7 (exit
    42) and a ``--resume`` run end in checkpoints whose every leaf is
    byte for byte the reference's (the ``.npz`` containers themselves
    hold their write times), with identical final-loss lines; and
    ``--mesh elastic`` raises ``NotImplementedError``.
"""
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JSyntheticLMData
from repro_torch.checkpoint import (CheckpointManager, all_steps, latest_step,
                                    restore, save)
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, Prefetcher, SyntheticLMData
from repro_torch.distributed.ft import PreemptionHandler, StepTimer
from repro_torch.launch.train import main as train_main
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["smollm-135m", "granite-moe-3b-a800m", "internvl2-1b",
         "mamba2-370m", "zamba2-7b", "seamless-m4t-medium"]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_at_equals_reference_bytes(arch, reduced):
    cfg, jcfg = get_config(arch), jax_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    dc = dict(batch=2, seq=16, vocab=min(cfg.vocab, 256), seed=5)
    ours = SyntheticLMData(DataConfig(**dc), model_cfg=cfg)
    ref = JSyntheticLMData(JDataConfig(**dc), model_cfg=jcfg)
    for step in (0, 3, 1000):
        got, want = ours.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys()
        extra = {"vlm": "patch_embeds", "encdec": "frames"}.get(cfg.family)
        assert set(got) == {"tokens", "labels"} | ({extra} - {None})
        for k in got:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), (arch, step, k)


def test_labels_are_next_tokens():
    b = SyntheticLMData(DataConfig()).batch_at(0)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert ((31 * b["tokens"] + 7) % 256 == b["labels"]).mean() > 0.8


def test_prefetcher_matches_sync_iteration():
    d = SyntheticLMData(DataConfig(seed=2))
    pf = Prefetcher(d.iterate(start_step=4), depth=2)
    try:
        for s in range(4, 8):
            assert pf.get()["tokens"].tobytes() == \
                d.batch_at(s)["tokens"].tobytes()
    finally:
        pf.close()


def test_prefetcher_raises_producer_error():
    def gen():
        yield 1
        raise RuntimeError("producer failed")

    pf = Prefetcher(gen(), depth=1)
    try:
        assert pf.get() == 1
        with pytest.raises(RuntimeError, match="producer failed"):
            pf.get()
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 16, generator=g),
                   "layers": [{"b": torch.zeros(16)},
                              {"b": torch.randn(16, generator=g)}]},
        "m": {"w": torch.ones(8, 16),
              "layers": [{"b": torch.zeros(16)}, {"b": torch.zeros(16)}]},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_save_restore_roundtrip(tmp_path):
    st = _state()
    save(st, tmp_path, step=7)
    got = restore(tmp_path, _state(1), device="cpu")
    assert _equal(got, st)
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert manifest["step"] == 7
    assert manifest["leaves"]["params::layers::1::b"] == \
        {"shape": [16], "dtype": "float32"}
    assert manifest["leaves"]["step"] == {"shape": [], "dtype": "int32"}
    with np.load(tmp_path / "step_7" / "arrays.npz") as data:
        assert sorted(data.files) == sorted(manifest["leaves"])


def test_atomic_no_partial_checkpoints(tmp_path):
    save(_state(), tmp_path, step=1)
    (tmp_path / "step_9.tmp").mkdir()  # a straggling writer's directory
    assert all_steps(tmp_path) == [1]
    assert latest_step(tmp_path) == 1


def test_gc_keeps_newest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save(_state(), tmp_path, step=s, keep=2)
    assert all_steps(tmp_path) == [4, 5]


def test_async_save(tmp_path):
    t = save(_state(), tmp_path, step=3, async_=True)
    assert isinstance(t, threading.Thread)
    t.join(timeout=30)
    assert not t.is_alive()
    assert latest_step(tmp_path) == 3


def test_async_save_copies_before_returning(tmp_path):
    """The writer thread writes the state as it was at the call: a later
    in-place update (the next step) does not reach the file."""
    st = _state()
    want = {"w": st["params"]["w"].clone()}
    t = save(st, tmp_path, step=1, async_=True)
    st["params"]["w"].add_(1.0)
    t.join(timeout=30)
    got = restore(tmp_path, _state(), device="cpu")
    assert torch.equal(got["params"]["w"], want["w"])


def test_manager_interval_and_force(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=10, keep=5, async_=False)
    st = _state()
    assert not mgr.maybe_save(st, 3)
    assert mgr.maybe_save(st, 10)
    assert mgr.maybe_save(st, 17, force=True)
    mgr.wait()
    assert set(all_steps(tmp_path)) == {10, 17}


def test_restore_dtype_cast(tmp_path):
    """Restore may change the precision policy (e.g. bf16 serving)."""
    st = _state()
    save(st, tmp_path, step=1)
    like = _state()
    like["params"]["w"] = like["params"]["w"].to(torch.bfloat16)
    got = restore(tmp_path, like, device="cpu")
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"], st["params"]["w"].bfloat16())


def test_bf16_round_trip_is_exact(tmp_path):
    w = torch.randn(33, 7, generator=torch.Generator().manual_seed(3))
    st = {"w": w.to(torch.bfloat16), "x": w}
    save(st, tmp_path, step=2)
    manifest = json.loads((tmp_path / "step_2" / "manifest.json").read_text())
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "step_2" / "arrays.npz") as data:
        assert data["w"].dtype == np.uint16
    got = restore(tmp_path, st, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), st["w"].view(torch.int16))
    meta = restore(tmp_path, {k: v.to("meta") for k, v in st.items()},
                   device="cpu")
    assert _equal(meta, st)


def test_restore_rejects_other_shapes_and_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(tmp_path, _state(), device="cpu")
    save(_state(), tmp_path, step=1)
    like = _state()
    like["params"]["w"] = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="params::w"):
        restore(tmp_path, like, device="cpu")


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_step_timer_flags_stragglers():
    t = StepTimer(threshold=2.0, warmup=3)
    for i in range(10):
        t.observe(i, 0.1)
    assert not t.stragglers
    t.observe(10, 0.5)
    assert t.stragglers == [10]
    t.observe(11, 0.1)             # the EMA was not poisoned
    assert t.stragglers == [10]


def test_preemption_handler_trigger_and_signal():
    h = PreemptionHandler()
    assert not h.preempted
    h.trigger()
    assert h.preempted
    old = signal.getsignal(signal.SIGUSR1)
    try:
        h2 = PreemptionHandler(signals=(signal.SIGUSR1,)).install()
        assert not h2.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h2.preempted
    finally:
        signal.signal(signal.SIGUSR1, old)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

DRILL = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
         "--steps", "14", "--batch", "2", "--seq", "32",
         "--ckpt-interval", "4", "--log-every", "1"]


def _train(*extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *DRILL, *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def _final_loss(out: str) -> str:
    lines = [ln for ln in out.splitlines() if "final loss" in ln]
    assert len(lines) == 1, out
    return lines[0]


def test_preempt_resume_bit_exact(tmp_path):
    ref = _train("--ckpt-dir", str(tmp_path / "ref"))
    assert ref.returncode == 0, ref.stderr[-2000:]
    killed = _train("--ckpt-dir", str(tmp_path / "run"), "--kill-at", "7")
    assert killed.returncode == 42, (killed.returncode, killed.stderr[-2000:])
    assert "preempted at step 7" in killed.stdout
    assert latest_step(tmp_path / "run") == 7
    resumed = _train("--ckpt-dir", str(tmp_path / "run"), "--resume")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "[train] resumed from step 7" in resumed.stdout
    assert _final_loss(resumed.stdout) == _final_loss(ref.stdout)
    a = np.load(tmp_path / "ref" / "step_14" / "arrays.npz")
    b = np.load(tmp_path / "run" / "step_14" / "arrays.npz")
    with a, b:
        assert sorted(a.files) == sorted(b.files)
        assert {k.split("::")[0] for k in a.files} == \
            {"params", "m", "v", "step"}
        for k in a.files:
            assert a[k].dtype == b[k].dtype and \
                a[k].tobytes() == b[k].tobytes(), k
    summary = json.loads(resumed.stdout.split("[train] summary ", 1)[1])
    assert summary["kernel_launches"] == {"flash_attention": 0,
                                          "ssd_scan": 0}


def test_elastic_mesh_not_ported(capsys):
    """``--mesh elastic`` (once not ported) on a world of one rank on the
    CPU: a (1, 1) mesh, DTensor state, the same losses as ``--mesh
    none`` bit for bit."""
    args = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "16"]
    assert train_main(args) == 0
    ref = capsys.readouterr().out
    assert train_main(args + ["--mesh", "elastic"]) == 0
    out = capsys.readouterr().out
    assert "[train] elastic mesh: {'data': 1, 'model': 1}" in out

    def summary(text):
        return json.loads(text.split("[train] summary ", 1)[1])
    assert summary(out)["losses"] == summary(ref)["losses"]
    assert summary(out)["mesh"] == {"data": 1, "model": 1}
