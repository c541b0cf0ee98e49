"""The harness at tiny shapes on the CPU: each cell prints a well-formed
last line; a broken timed path makes `correct` false; every file the
manifest names is found by name, and a dummy cell, configuration,
traffic mix and metric added as new files are found too."""
import json
import os
import shutil

import pytest

from bench_tiny import HERE, ROOT, run_cell

CELLS = ("complex-train", "complex-anim")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_a_well_formed_line(cell, capsys, one_thread):
    rc, line, err = run_cell(cell, 2 ** 31 + 17, capsys)
    assert rc == 0, err
    assert set(line) == KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in manifest()["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    # the numbers compared, beside their limits, end standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def _unchanged_state(monkeypatch):
    """A training step that returns its state unchanged."""
    from sings_tpu_torch.train import trainer

    make = trainer.make_train_scan

    def broken(step, stat_fn=None):
        scan = make(step, stat_fn)

        def scan_unchanged(params, buffers, opt_state, *a, **kw):
            out = scan(params, buffers, opt_state, *a, **kw)
            return (params, buffers, opt_state) + tuple(out[3:])
        return scan_unchanged

    monkeypatch.setattr(trainer, "make_train_scan", broken)


def _half_batch(monkeypatch):
    """Half of each step's patches left out, the mean over the rest."""
    from sings_tpu_torch.train import step

    loss = step.photometric_loss

    def half(draws, *a, **kw):
        n = draws["ys"].shape[0] // 2
        return loss(dict(draws, ys=draws["ys"][:n], xs=draws["xs"][:n]),
                    *a, **kw)

    monkeypatch.setattr(step, "photometric_loss", half)


def _altered_frame(monkeypatch):
    """A frame altered where it is produced: one tile of it inverted."""
    from sings_tpu_torch.train import trainer

    quantize = trainer.quantize

    def altered(render):
        img = quantize(render).clone()
        img[:16, :16] = 255 - img[:16, :16]
        return img

    monkeypatch.setattr(trainer, "quantize", altered)


def _half_chunk(monkeypatch):
    """Half of each chunk's frames left out: the second half repeats the
    first."""
    import torch

    from sings_tpu_torch.train.trainer import Trainer

    render = Trainer.render_chunk

    def half(self, gs_attrs, chunk):
        frames = render(self, gs_attrs, chunk)
        n = frames.shape[0] // 2
        return torch.cat([frames[:n], frames[:n], frames[:1]])[
            :frames.shape[0]]

    monkeypatch.setattr(Trainer, "render_chunk", half)


# the faults each cell can have; the exchange between chips has none to
# leave out on one card, and a training cell produces no answers of its
# own besides its state, which the unchanged-state fault covers
@pytest.mark.parametrize("cell,fault", [
    ("complex-train", _unchanged_state), ("complex-train", _half_batch),
    ("complex-anim", _altered_frame), ("complex-anim", _half_chunk)])
def test_a_broken_timed_path_is_not_correct(cell, fault, capsys,
                                            monkeypatch, one_thread):
    fault(monkeypatch)
    rc, line, err = run_cell(cell, 5, capsys)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


def test_every_file_of_the_manifest_is_found_by_name():
    import run

    man = manifest()
    assert man["paths"] == ["benchmark"]
    for c in man["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in man["workloads"]:
        files = run.cell_files(ROOT, man, w["name"])
        assert os.path.isfile(os.path.join(
            HERE, "runners", files["traffic"]["runner"] + ".py"))
        assert files["per_layer"] and files["end_to_end"]
        assert {"setup_s"} < {m["name"] for m in files["end_to_end"]}
    for m in man["per_layer"]:
        assert callable(run.metric_reader(HERE, m["name"]).read)


def test_a_dummy_cell_is_found_and_runs(tmp_path, capsys, one_thread):
    """New files and new manifest entries only: a configuration, a
    traffic mix, limits and a per-layer metric, in a copy of the
    checkout's benchmark; the harness finds each by name and runs the
    new cell."""
    import run

    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "sings_tpu_torch"),
               root / "sings_tpu_torch")
    man = manifest()
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "human_complex.json").read_text())
    cfg["name"] = "dummy_config"
    (bench / "configs" / "dummy_config.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "train_chunks.json").read_text())
    mix["trace_chunks"] = 1
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (bench / "limits" / "dummy-cell.json").write_text(
        (bench / "limits" / "complex-train.json").read_text())
    (bench / "metrics" / "dummy_metric.train.py").write_text(
        "def read(run):\n    return 1.0\n")
    man["configs"].append(dict(man["configs"][0], name="dummy_config",
                               file="benchmark/configs/dummy_config.json"))
    man["workloads"].append({"name": "dummy-cell", "config": "dummy_config",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "a dummy"})
    for m in man["end_to_end"]:
        if "complex-train" in m.get("workloads", []):
            m["workloads"].append("dummy-cell")
    man["per_layer"].append({
        "name": "dummy_metric.train", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "device (H100)",
        "moves": "train_steps_per_s", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    files = run.cell_files(str(root), man, "dummy-cell")
    assert files["config"]["name"] == "dummy_config"
    assert files["traffic"]["trace_chunks"] == 1
    assert [m["name"] for m in files["per_layer"]] == ["dummy_metric.train"]
    assert run.metric_reader(files["here"],
                             "dummy_metric.train").read(None) == 1.0
    rc, line, err = run_cell("dummy-cell", 3, capsys, root=str(root))
    assert rc == 0, err
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_steps_per_s", "setup_s"}
