"""The port's plan miner (``pilosa_tpu_torch.util.plan_miner``) against the
JAX package's (``pilosa_tpu.util.plan_miner``) on the same recorded plans:
the shared-subtree report ``mine`` and its ``render`` text, the dump
flattening, the transition report ``mine_sequences`` and its
``render_sequences`` text, and the CLI (``python -m
pilosa_tpu_torch.util.plan_miner``, the port of ``scripts/plan_miner.py``)
on a saved dump against the reference's script.  Counts, probabilities
and texts: exact agreement."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from pilosa_tpu.util import plan_miner as jminer
from pilosa_tpu_torch.util import plan_miner as tminer

ROOT = Path(__file__).resolve().parent.parent
SEG = "Intersect(Row(seg=0), Row(seg=1), Row(seg=2), Row(seg=3))"


def recorded_dump():
    """A /debug/plans document: a dashboard burst sharing one segment
    subtree, the same subtree in a later window and in another index, a
    truncated text, repeated sequences of two signatures, a slow-plan
    retention repeating a recent plan, and a plan with no query."""
    recent = [
        {"index": "i", "query": f"Count(Intersect({SEG}, Row(w=5)))", "startTime": 100.0,
         "traceID": "a"},
        {"index": "i", "query": f"Count(Intersect({SEG}, Row(w=6)))", "startTime": 101.0,
         "traceID": "b"},
        {"index": "i", "query": f"Sum({SEG}, field=v)", "startTime": 102.0, "traceID": "c"},
        {"index": "i", "query": f"TopN(w, {SEG}, n=3)", "startTime": 103.0, "traceID": "d"},
        {"index": "i", "query": f"Min({SEG}, field=v)", "startTime": 900.0, "traceID": "e"},
        {"index": "j", "query": f"Sum({SEG}, field=v)", "startTime": 104.0, "traceID": "f"},
        {"index": "i", "query": "Count(Intersect(Row(f=1", "startTime": 105.0, "traceID": "g"},
        {"index": "i", "query": "GroupBy(Rows(field=g), Rows(field=w))", "startTime": 106.0,
         "traceID": "h"},
        {"index": "i", "startTime": 107.0, "traceID": "no-query"},
    ]
    t = 1000.0
    for k in range(5):
        recent.append({"index": "i", "query": "Count(Row(f=0))", "startTime": t,
                       "traceID": f"s{k}"})
        t += 0.1
        recent.append({"index": "i", "query": "Count(Union(Row(f=8), Row(f=9)))",
                       "startTime": t, "traceID": f"u{k}"})
        t += 0.1
    return {"recent": recent, "slow": {"Count": [dict(recent[0])]}}


@pytest.mark.parametrize("window", [0.0, 1.0, 60.0])
@pytest.mark.parametrize("top", [1, 20])
def test_mine_and_render_match_the_reference(window, top):
    doc = recorded_dump()
    plans = tminer.flatten_plans(doc)
    assert plans == jminer.flatten_plans(doc) and len(plans) == len(doc["recent"])
    got, want = tminer.mine(plans, window_s=window, top=top), jminer.mine(plans, window_s=window,
                                                                          top=top)
    assert got == want and got["queries"] == 16  # the truncated and empty texts skipped
    assert tminer.render(got) == jminer.render(want)


def test_mine_counts_the_shared_segment():
    """The segment's four occurrences in the burst's window: three
    evaluations a fuse saves (after tests/test_fusion.py's reference
    test)."""
    r = tminer.mine(tminer.flatten_plans(recorded_dump()), window_s=60.0)
    seg = next(a for a in r["topShared"] if a["mask"] == SEG and a["index"] == "i")
    assert seg["evals_saved"] == 3 and seg["occurrences"] == 5 and seg["windows"] == 2
    assert "fusion would save" in tminer.render(r)


@pytest.mark.parametrize("window", [0.05, 0.15, 5.0])
def test_mine_sequences_and_render_match_the_reference(window):
    plans = tminer.flatten_plans(recorded_dump())
    got = tminer.mine_sequences(plans, window_s=window, top=3)
    want = jminer.mine_sequences(plans, window_s=window, top=3)
    assert got == want
    assert tminer.render_sequences(got) == jminer.render_sequences(want)


@pytest.mark.parametrize("flags", [[], ["--json"], ["--sequences"], ["--sequences", "--json"],
                                   ["--window", "0.15", "--sequences", "--json"],
                                   ["--window", "1", "--top", "2"]])
def test_cli_on_a_file_matches_the_reference_script(tmp_path, flags):
    dump = tmp_path / "plans.json"
    dump.write_text(json.dumps(recorded_dump()))
    want = subprocess.run([sys.executable, str(ROOT / "scripts" / "plan_miner.py"), "--file",
                           str(dump)] + flags, capture_output=True, text=True, timeout=120,
                          check=True, env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    got = subprocess.run([sys.executable, "-m", "pilosa_tpu_torch.util.plan_miner", "--file",
                          str(dump)] + flags, capture_output=True, text=True, timeout=60,
                         check=True, cwd=ROOT)
    assert got.stdout == want.stdout and got.stdout.strip()
    if "--json" in flags and "--sequences" in flags:
        assert json.loads(got.stdout)["observed"] == 18


def test_main_in_process(tmp_path, capsys):
    dump = tmp_path / "plans.json"
    dump.write_text(json.dumps(recorded_dump()))
    assert tminer.main(["--file", str(dump), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc == jminer.mine(jminer.flatten_plans(recorded_dump()), window_s=60.0, top=20)
    with pytest.raises(SystemExit):
        tminer.main([])  # --url or --file is required
