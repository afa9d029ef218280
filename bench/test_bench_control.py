"""The comparison that decides ``correct`` fails what it has to, at a size
a CPU test run holds: the control (the float32 reference computed in
fp8, the step below the bf16 the configurations state, put in the
program's place) reads past the program on every seed, three times or
more on the prefill logits, and limits set between the two by the
benchmark's rule pass the program and fail the control; a run whose
timed path is broken underneath — a decode step that returns its state
unchanged, a token altered where it is produced, a prefill's answer
altered, a router that probes a node more than its policy picks — comes
out not correct. Each run skips the harness's look for a chip and drives
the rest of a run on the CPU at a tiny size of the cell, for a fixed
number of requests. (The cells serve one request at a time on one chip,
so "half the batch left out" and "the exchange between chips left out"
have no place to happen.) The cells' own limits come from the same
experiment on the card at their own sizes (``bench/limits``)."""
import pytest
import torch

from bench import harness
from bench.conftest import TINY, TINY_TRAFFIC

CELLS = ["mamba2-370m.docqa", "mamba2-370m.unshared"]
SEEDS = [2**31 + 17, 2**31 + 18, 2**31 + 19]
NUMBERS = ("prefill_logit_err", "decode_gap")
REQUESTS = 24


def _cell(name):
    return harness.load_cell(name, model_over=TINY[name.split(".")[0]],
                             traffic_over=TINY_TRAFFIC)


@pytest.fixture(scope="module")
def readings():
    """{cell: [(program's numbers, control's numbers) a seed]}."""
    out = {}
    for name in CELLS:
        cell = _cell(name)
        out[name] = []
        for seed in SEEDS:
            sv = harness.serve_cell(cell, seed, 600.0, False, device="cpu",
                                    t_start=0.0, requests=REQUESTS)
            out[name].append(tuple(
                {k: c["value"] for k, c in harness.verify(
                    cell, sv, seed, control=control)[0].items()}
                for control in (False, True)))
    return out


def _limits(rows):
    """Limits set by the benchmark's rule from these readings: between the
    program's largest and the control's least."""
    lim = {"route_mismatch": {"limit": 0}}
    for k in NUMBERS:
        lower = max(p[k] for p, _ in rows)
        upper = min(c[k] for _, c in rows)
        lim[k] = {"limit": (lower + upper) / 2}
    return lim


def _failing(checks):
    return sorted(k for k, c in checks.items()
                  if c["value"] is None or c["value"] > c["limit"])


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_three_times_the_program(name, readings):
    """The prefill logits separate at this size; the widest decode gap of
    a tiny model's nearly flat logits may not (on the card, at the cells'
    sizes, both do: ``bench/limits``)."""
    rows = readings[name]
    lower = max(p["prefill_logit_err"] for p, _ in rows)
    assert 0 < 3 * lower <= min(c["prefill_logit_err"] for _, c in rows)
    for k in NUMBERS:
        assert min(c[k] for _, c in rows) > max(p[k] for p, _ in rows)


@pytest.mark.parametrize("name", CELLS)
def test_limits_by_the_rule_pass_the_program_and_fail_the_control(
        name, readings):
    lim = _limits(readings[name])
    for prog, ctl in readings[name]:
        assert all(prog[k] <= lim[k]["limit"] for k in NUMBERS)
        assert any(ctl[k] > lim[k]["limit"] for k in NUMBERS)


def _run(name, limits=None, patch=None):
    cell = _cell(name)
    if limits is not None:
        cell.limits = limits
    return harness.run_cell(cell, SEEDS[0], 600.0, False, device="cpu",
                            t_start=0.0, patch=patch, requests=REQUESTS)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_under_both_limits(name, readings):
    for lim in (None, _limits(readings[name])):
        result, checks = _run(name, lim)
        assert result["correct"] and _failing(checks) == [], checks


def _stale_state(server):
    model = server.engine.model
    step = model.decode_step

    def unchanged(params, cache, tokens):
        copy = {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in cache.items()}
        logits, _ = step(params, copy, tokens)
        return logits, cache
    model.decode_step = unchanged


def _altered_token(server):
    model = server.engine.model
    step = model.decode_step

    def altered(params, cache, tokens):
        logits, cache = step(params, cache, tokens)
        return logits.roll(1, dims=-1), cache
    model.decode_step = altered


def _altered_prefill(server):
    engine = server.engine
    prefill = engine.prefill

    def altered(tokens, max_len):
        logits, kv = prefill(tokens, max_len)
        return logits * 1.5, kv
    engine.prefill = altered


def _extra_probe(server):
    router = server.cluster.router
    select = router.select

    def more(key):
        sel, ind = select(key)
        rest = [j for j in range(len(router.nodes)) if j not in sel]
        return sorted(sel + rest[:1]), ind
    router.select = more


FAULTS = {"stale_state": (_stale_state, "decode_gap"),
          "altered_token": (_altered_token, "decode_gap"),
          "altered_prefill": (_altered_prefill, "prefill_logit_err"),
          "extra_probe": (_extra_probe, "route_mismatch")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, readings):
    patch, caught_by = FAULTS[fault]
    result, checks = _run(name, _limits(readings[name]), patch)
    assert not result["correct"]
    assert caught_by in _failing(checks), checks
