"""What a run does around the measurement: finding its files by name,
refusing to run without a card, and coming out not correct when the timed
path is broken underneath or the control takes the program's place."""

import json
import re
from collections import Counter
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import check, harness, spec
from port_bench.readings import half_batch, permuted_matches, roll_matches

DATA = Path(__file__).resolve().parent / "data"
HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def run_cell(name, seed=2 ** 31 + 11, **kw):
    cell = spec.load_cell(name, root=DATA, here=DATA)
    run = spec.kind_runner(cell.traffic["kind"])
    seconds = 0.0 if cell.traffic["kind"] == "train" else 1.0
    r = run(cell, seed, seconds, False, torch.device("cpu"),
            log=lambda *a: None, **kw)
    return check.judge(r["numbers"], cell.limits) and r["failed"] == 0


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(DATA, tmp_path, dirs_exist_ok=True)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "traffic" / "new_mix.json").write_text(json.dumps(
        {"kind": "train", "batch_per_rank": 1, "pool_batches": 4,
         "classes_per_image": [1, 3], "ignore_share": 0.0,
         "traced_steps": 1}))
    (tmp_path / "limits" / "new_cell.json").write_text('{"loss_gap": 1}')
    (tmp_path / "metrics" / "new_metric.train.py").write_text(
        'UNIT = "ms"\n\ndef read(ctx):\n    return 1.5\n')
    (tmp_path / "metrics" / "new_rate.py").write_text(
        'UNIT = "img/s"\n\ndef read(ctx):\n    return ctx.rate\n')
    (tmp_path / "kinds").mkdir()
    (tmp_path / "kinds" / "new_kind.py").write_text(
        'def run(cell, seed, seconds, trace, device, log=print):\n'
        '    return {"seed": seed}\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "new_cell", "config": "tiny_m2f",
                               "traffic": "new_mix", "chips": 1})
    bench["per_layer"].append({"name": "new_metric.train", "unit": "ms",
                               "workloads": ["new_cell"]})
    bench["end_to_end"].append({"name": "new_rate", "unit": "img/s",
                                "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("new_cell", root=tmp_path, here=tmp_path)
    assert cell.traffic["batch_per_rank"] == 1
    assert cell.config["name"] == "tiny_m2f"
    assert [m["name"] for m in cell.per_layer] == ["new_metric.train"]
    assert spec.metric_reader("new_metric.train", here=tmp_path).read(
        None) == 1.5
    assert [m["name"] for m in cell.end_to_end][-1] == "new_rate"
    ctx = harness.Context("train", cell, 2.5, build_s=0.0, batch=1)
    assert harness.read_metrics(cell.end_to_end[-1:], ctx, print,
                                here=tmp_path) == {
        "new_rate": {"value": 2.5, "unit": "img/s"}}
    assert spec.kind_runner("new_kind", here=tmp_path)(
        cell, 7, 1.0, False, None) == {"seed": 7}
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell", root=tmp_path, here=tmp_path)


def test_benchmark_json_is_well_formed():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        spec.load_cell(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        reader = spec.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"])
        assert m["moves"] in e2e
    for m in bench["end_to_end"]:
        reader = spec.metric_reader(m["name"])
        assert (reader.UNIT, reader.SOURCE) == (m["unit"], m["source"])
    kinds = {json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                        .read_text())["kind"] for w in bench["workloads"]}
    assert all(callable(spec.kind_runner(k)) for k in kinds)


def test_a_cell_on_several_cards_runs_one_process_a_card(monkeypatch):
    cell = spec.load_cell("m2f_beitl640_train")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert harness.launch_command(cell, ["--seed", "1"]) is None
    cell.chips = 4
    cmd = harness.launch_command(cell, ["--seed", "1"])
    assert cmd[1:4] == ["-m", "torch.distributed.run", "--standalone"]
    assert "--nproc_per_node=4" in cmd
    assert cmd[-3:] == [str(HERE / "run.py"), "--seed", "1"]
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert harness.launch_command(cell, ["--seed", "1"]) is None


def test_the_rate_leaves_the_traced_span_out():
    cell = spec.load_cell("tiny_m2f_train", root=DATA, here=DATA)
    span = harness.Span(None, 2, 3.0, Counter(msda_fwd=4))
    # 10 steps of 4 images in 8 s, 2 of them traced in 3 s
    ctx = harness.Context.of_window("train", cell, 4, 10, 8.0, span,
                                    build_s=1.0)
    assert ctx.rate == pytest.approx(8 * 4 / 5.0)
    assert ctx.traced_units == 2 and ctx.launches["msda_fwd"] == 4
    ctx = harness.Context.of_window("train", cell, 4, 10, 8.0, None,
                                    build_s=1.0)
    assert ctx.rate == pytest.approx(40 / 8.0) and ctx.traced_units == 0


def _run_py(cwd, *args):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "m2f_beitl640_train", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, capture_output=True, text=True)


def test_without_a_card_a_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def _unchanged(step):
    """A step that returns its state unchanged: no update is applied."""
    def broken(state, batch, gen):
        opt = state.optimizer
        real = opt.step
        opt.step = lambda: torch.zeros(())
        try:
            return step(state, batch, gen)
        finally:
            opt.step = real
    return broken


def _altered_answer(model):
    """One crop's answer altered where it is produced."""
    def broken(x):
        out = model(x).clone()
        out[0] = out[0].roll(1, dims=-1)
        return out
    return broken


@pytest.mark.parametrize("cell,fault", [
    ("tiny_m2f_fp32_train", {"wrap_step": _unchanged}),
    ("tiny_m2f_fp32_train", {"wrap_step": half_batch}),
    ("tiny_upernet_fp32_train", {"wrap_step": _unchanged}),
    ("tiny_upernet_fp32_train", {"wrap_step": half_batch}),
    ("tiny_m2f_fp32_infer", {"wrap_model": _altered_answer}),
])
def test_a_broken_timed_path_comes_out_not_correct(cell, fault):
    assert run_cell(cell)
    assert not run_cell(cell, **fault)


def test_the_logits_gap_is_infinite_without_logits_of_the_same_shape():
    ref = [torch.ones(2, 3), torch.full((4,), 2.0)]
    assert check.logits_gap([t * 1.01 for t in ref], ref) == \
        pytest.approx(0.01)
    assert check.logits_gap(None, ref) == float("inf")
    assert check.logits_gap([ref[0][:1], ref[1]], ref) == float("inf")


def test_permuted_matches_stay_a_matching():
    a = torch.tensor([[2, -1, 0, 1, -1], [-1, 0, -1, -1, -1]])
    b = roll_matches(a)
    assert b.tolist() == [[1, -1, 2, 0, -1], [-1, 0, -1, -1, -1]]


@pytest.mark.parametrize("cell", ["tiny_m2f_fp32_train", "tiny_m2f_train"])
def test_a_wrong_matching_comes_out_not_correct(cell):
    """The auction's answer altered where it is produced: a valid matching
    of every gt, but not the one the costs give."""
    assert run_cell(cell)
    with permuted_matches():
        assert not run_cell(cell)


@pytest.mark.parametrize("cell", ["tiny_m2f_train", "tiny_upernet_train"])
def test_the_control_comes_out_not_correct(cell):
    assert run_cell(cell)
    assert not run_cell(cell, lower_control=True)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["m2f_beitl640_train",
                                  "upernet_augregl512_train",
                                  "m2f_beitl640_infer"])
def test_the_control_at_the_cell_size_comes_out_not_correct(card, cell):
    c = spec.load_cell(cell)
    run = spec.kind_runner(c.traffic["kind"])
    seconds = 0.0 if c.traffic["kind"] == "train" else 5.0
    for seed in (3_000_000_901, 3_000_000_902, 3_000_000_903):
        r = run(c, seed, seconds, False, card, log=lambda *a: None,
                lower_control=True)
        assert not check.judge(r["numbers"], c.limits), r["numbers"]
