"""The pool cell (complex-pool2) on the CPU: the whole run at tiny
shapes, the faults that mix the cases, the controls, and the count of a
case-step."""
import json
import time

import pytest
import torch

from bench_tiny import run_cell, tiny

CELL = "complex-pool2"


def test_a_tiny_run_of_the_cell_is_correct(capsys, one_thread):
    rc, line, err = run_cell(CELL, 2 ** 31 + 19, capsys)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                   "mu_gap", "nu_gap"}
    assert set(line["metrics"]) == {"train_steps_per_s", "setup_s"}
    # every case-step counts: two a lockstep step
    assert line["attempted"] >= 2 * 8 and line["attempted"] % 2 == 0


def _swapped_draws(monkeypatch):
    """The program steps each case with the other case's draws."""
    from sings_tpu_torch.train.trainer_cases import CasePool

    scan = CasePool.train_scan

    def swapped(self, k, frames=None, draws=None):
        return scan(self, k, frames=frames,
                    draws=None if draws is None else draws[::-1])

    monkeypatch.setattr(CasePool, "train_scan", swapped)


def _case0_targets(monkeypatch):
    """The program trains case 1 on case 0's targets."""
    from sings_tpu_torch.train.trainer_cases import CasePool

    init = CasePool.__init__

    def built(self, *args, **kw):
        init(self, *args, **kw)
        a, b = self.trainers[:2]
        b.images, b.masks = a.images, a.masks

    monkeypatch.setattr(CasePool, "__init__", built)


@pytest.mark.parametrize("fault", [_swapped_draws, _case0_targets])
def test_a_fault_that_mixes_the_cases_is_not_correct(fault, capsys,
                                                     monkeypatch, one_thread):
    import run

    fault(monkeypatch)
    rc = run.main(["--workload", CELL, "--seed", "5", "--seconds", "0.5"],
                  device=torch.device("cpu"), overrides=tiny(CELL),
                  t_start=time.time())
    out = capsys.readouterr().out
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("kind", ["half_batch", "swap_draws"])
def test_the_controls_fail_the_cell(kind, capsys, one_thread):
    import control_pool
    import run

    limits = run.cell_files(run.ROOT, run.manifest(run.ROOT), CELL)[
        "limits"]
    assert control_pool.main(["--kind", kind, "--seeds", "3"],
                             device=torch.device("cpu"),
                             overrides=tiny(CELL)) == 0
    out = capsys.readouterr().out
    readings = json.loads(out.strip().splitlines()[-1])["readings"]
    for seed, numbers in readings.items():
        assert any(v > limits[k] for k, v in numbers.items()), (seed,
                                                                numbers)


def test_a_run_without_train_scan_fails_at_once(capsys, monkeypatch,
                                                one_thread):
    """The parent's CasePool, which has no train_scan: the run raises
    before it makes any input."""
    import run
    from runners import train as base
    from sings_tpu_torch.train.trainer_cases import CasePool

    made = []
    monkeypatch.delattr(CasePool, "train_scan")
    monkeypatch.setattr(base, "reference_inputs",
                        lambda ctx: made.append(ctx) or {})
    with pytest.raises(RuntimeError, match="no train_scan"):
        run.main(["--workload", CELL, "--seed", "5", "--seconds", "0.5"],
                 device=torch.device("cpu"), overrides=tiny(CELL),
                 t_start=time.time())
    assert not made


def test_the_case_step_count_takes_the_statistic_whole():
    """counts/pool.py: flops.train_step plus (k - 1) / k of the
    statistic's KNN_OPS n_live^2, at tiny sizes."""
    from counts import flops, pool

    s = {"n_live": 300, "n_edges": 3, "geo": {"a": (1, 1)},
         "app": {"b": (1, 2)}, "c": 1, "scales": 1, "joints": 1,
         "patches": 4, "patch": 8, "height": 2, "width": 2, "params": 5,
         "k": 8, "composite_fwd_ops": 7, "composite_bwd_ops": 11}
    want = flops.train_step(s) + 7 / 8 * flops.KNN_OPS * 300 * 300
    assert pool.case_step(s) == pytest.approx(want, rel=1e-12)
    assert pool.case_step(dict(s, k=1)) == pytest.approx(flops.train_step(
        dict(s, k=1)), rel=1e-12)
