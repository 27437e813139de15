"""The port's entry point, ``python -m repro_torch.launch.serve``, on the
CPU at reduced sizes: both families (the MoE and MLA archs among the
LMs), plain and speculative generation, the floating-point baseline, a
uniform policy, frontier serving under a deadline, the roofline lines,
the telemetry files it
writes (held to the JAX package's validators and to the port's own
``python -m repro_torch.runtime.telemetry validate``), and the flags it
refuses, as the JAX launcher refuses them.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.runtime import telemetry as jtele  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PLANS = ROOT / "examples" / "plans"
CPU = ["--device", "cpu", "--reduced"]


def _check_telemetry(trace, metrics):
    assert jtele.validate_chrome_trace(json.loads(trace.read_text())) == []
    assert jtele.validate_metrics_text(metrics.read_text()) == []


def test_resnet18(tmp_path, capsys):
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    assert serve.main(["--arch", "resnet18", *CPU, "--plan",
                       str(PLANS / "resnet18_mixed.json"), "--batch", "3",
                       "--trace", str(trace), "--metrics-dump", str(prom),
                       "--profile", str(tmp_path / "prof")]) == 0
    out = capsys.readouterr().out
    assert "3 images in" in out and "logits (3, 10)" in out
    _check_telemetry(trace, prom)
    spans = [e for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("name") == "predict"]
    assert len(spans) == 2 and spans[0]["args"]["bucket"] == 3
    assert (tmp_path / "prof" / "trace.json").exists()


def test_granite_speculative(tmp_path, capsys):
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    assert serve.main(["--arch", "granite-8b", *CPU, "--plan",
                       str(PLANS / "granite_8b_mixed.json"), "--spec-decode",
                       "4", "--draft-plan",
                       str(PLANS / "granite_8b_draft_w2.json"), "--batch", "2",
                       "--prompt-len", "6", "--new-tokens", "9", "--trace",
                       str(trace), "--metrics-dump", str(prom)]) == 0
    out = capsys.readouterr().out
    assert "spec-decode k=4" in out and "specdec accept rate" in out
    assert "18 tokens in" in out
    _check_telemetry(trace, prom)
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"prefill", "specdec.draft", "specdec.verify",
            "specdec.accept"} <= names
    text = prom.read_text()
    assert "repro_specdec_drafted_total" in text
    assert "repro_specdec_accept_rate" in text


def test_granite_plain_and_the_same_tokens(capsys):
    """Speculative output equals the plan served alone: both runs draw the
    same weights from the same seed."""
    args = ["--arch", "granite-8b", *CPU, "--plan",
            str(PLANS / "granite_8b_mixed.json"), "--batch", "2",
            "--prompt-len", "5", "--new-tokens", "7", "--seed", "3"]
    assert serve.main(args) == 0
    plain = capsys.readouterr().out
    assert serve.main(args + ["--spec-decode", "2", "--draft-plan",
                              str(PLANS / "granite_8b_draft_w2.json")]) == 0
    spec = capsys.readouterr().out

    def sample(text):
        return [ln for ln in text.splitlines() if "sample:" in ln]
    assert sample(plain) == sample(spec) and len(sample(plain)) == 1


def test_olmoe(capsys):
    assert serve.main(["--arch", "olmoe-1b-7b", *CPU, "--batch", "2",
                       "--prompt-len", "7", "--new-tokens", "5"]) == 0
    out = capsys.readouterr().out
    assert "10 tokens in" in out and "expert" in out


def test_deepseek_speculative_and_the_same_tokens(tmp_path, capsys):
    """MLA and MoE under ``--spec-decode 2`` (a w2k2 draft without KV keys:
    the latent cache is not quantized): the same sample as the model
    served alone, since its verify equals its decode steps."""
    draft = json.loads((PLANS / "granite_8b_draft_w2.json").read_text())
    draft.pop("kv")
    draft.update(arch="deepseek-v2-lite-16b", name="deepseek-draft-w2")
    path = tmp_path / "draft.json"
    path.write_text(json.dumps(draft))
    args = ["--arch", "deepseek-v2-lite-16b", *CPU, "--batch", "2",
            "--prompt-len", "6", "--new-tokens", "7", "--seed", "2"]
    assert serve.main(args) == 0
    plain = capsys.readouterr().out
    assert serve.main(args + ["--spec-decode", "2", "--draft-plan",
                              str(path)]) == 0
    spec = capsys.readouterr().out
    assert "spec-decode k=2" in spec and "specdec accept rate" in spec

    def sample(text):
        return [ln for ln in text.splitlines() if "sample:" in ln]
    assert sample(plain) == sample(spec) and len(sample(plain)) == 1


@pytest.mark.parametrize("argv,match", [
    (["--arch", "granite-8b", "--spec-decode", "4"], "--draft-plan"),
    (["--arch", "resnet18", "--spec-decode", "4", "--draft-plan",
      str(PLANS / "granite_8b_draft_w2.json")], "LM archs"),
])
def test_refused_combinations(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(argv + CPU)


@pytest.mark.parametrize("flag", ["--mesh", "--devices",
                                  "--xla-serving-flags"])
def test_flags_waiting_for_modules_are_absent(flag, capsys):
    """``--xla-serving-flags`` (XLA only) is absent; ``--mesh`` and
    ``--devices`` are served since the mesh was ported, and refuse a
    malformed value ('1' is no DxM spec, 0 ranks no world) as argparse
    refuses any."""
    value = {"--mesh": "1", "--devices": "0"}.get(flag, "1")
    with pytest.raises(SystemExit) as err:
        serve.main(["--arch", "resnet18", *CPU, flag, value])
    assert err.value.code == 2
    want = ("unrecognized arguments" if flag == "--xla-serving-flags"
            else f"argument {flag}")
    assert want in capsys.readouterr().err


def test_mesh_model_axis_refused():
    """A 'model' axis above 1 serves every arch; one its heads do not
    split over (mamba2's 8 SSD heads over 3 ranks) exits before any rank
    starts, naming both numbers."""
    with pytest.raises(SystemExit, match="8 heads do not split evenly .* "
                                         "of 3"):
        serve.main(["--arch", "mamba2-1.3b", *CPU, "--mesh", "1x3"])


def test_mesh_needs_its_ranks():
    with pytest.raises(SystemExit, match="needs 4 ranks"):
        serve.main(["--arch", "granite-8b", *CPU, "--mesh", "4x1",
                    "--devices", "2"])


def test_two_local_ranks_serve_as_one_device(tmp_path):
    """``--devices 2 --mesh 2x1`` starts two ranks; rank 0 prints the same
    sample as the single-device run (greedy, bitwise)."""
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "granite-8b", *CPU, "--batch", "3", "--prompt-len", "6",
            "--new-tokens", "4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = [subprocess.run(args + extra, capture_output=True, text=True,
                           env=env, timeout=240, cwd=tmp_path)
            for extra in ([], ["--devices", "2", "--mesh", "2x1"])]
    for r in outs:
        assert r.returncode == 0, r.stderr[-2000:]

    def sample(text):
        return [ln for ln in text.splitlines() if "sample:" in ln]
    assert len(sample(outs[0].stdout)) == 1
    assert sample(outs[0].stdout) == sample(outs[1].stdout)
    assert "mesh {'data': 2, 'model': 1} over 2 ranks" in outs[1].stdout


def test_tensor_parallel_ranks_serve_as_one_device(tmp_path):
    """``--devices 2 --mesh 1x2`` serves granite-8b tensor-parallel over
    two ranks; rank 0 prints the single-device run's greedy sample."""
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "granite-8b", *CPU, "--batch", "3", "--prompt-len", "6",
            "--new-tokens", "4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = [subprocess.run(args + extra, capture_output=True, text=True,
                           env=env, timeout=240, cwd=tmp_path)
            for extra in ([], ["--devices", "2", "--mesh", "1x2"])]
    for r in outs:
        assert r.returncode == 0, r.stderr[-2000:]

    def sample(text):
        return [ln for ln in text.splitlines() if "sample:" in ln]
    assert len(sample(outs[0].stdout)) == 1
    assert sample(outs[0].stdout) == sample(outs[1].stdout)
    assert "mesh {'data': 1, 'model': 2} over 2 ranks" in outs[1].stdout


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "resnet18", "--reduced"])


def test_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "resnet18", *CPU, "--batch", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "2 images in" in r.stdout


FRONTIER = ROOT / "examples" / "frontiers" / "resnet18_frontier.json"


def test_resnet_frontier_under_a_deadline(tmp_path, capsys):
    """A burst and a trickle through the SLO scheduler; every request is
    accounted for and the run ends at the accurate point.  (Whether the
    burst degrades depends on the host's speed here; the degradation and
    recovery are held on a fake clock in ``test_torch_slo.py``.)"""
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    assert serve.main(["--arch", "resnet18", *CPU, "--frontier",
                       str(FRONTIER), "--slo-ms", "4000", "--batch", "2",
                       "--trace", str(trace), "--metrics-dump",
                       str(prom)]) == 0
    out = capsys.readouterr().out
    assert "packed 3 plan points of resnet18" in out
    assert "uniform-w8k4 -> resnet18-mixed-w8w4w2 -> uniform-w2k2" in out
    n = int(re.search(r"\] (\d+) requests in", out).group(1))
    served = re.search(r"served by (\{.*\})", out).group(1)
    assert sum(eval(served).values()) == n >= 33
    line = next(ln for ln in out.splitlines() if "degraded=" in ln)
    assert "drained back to level 0" in line
    _check_telemetry(trace, prom)
    assert "repro_frontier_serve_total" in prom.read_text()


def test_granite_frontier(capsys):
    path = ROOT / "build" / "granite_frontier_test.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps({
        "version": 1, "name": "granite", "arch": "granite-8b", "points": [
            {"plan": str(PLANS / "granite_8b_mixed.json"),
             "rel_latency": 1.0, "error": 0.0},
            {"plan": str(PLANS / "granite_8b_draft_w2.json"),
             "rel_latency": 0.5, "error": 0.1}]}))
    try:
        assert serve.main(["--arch", "granite-8b", *CPU, "--frontier",
                           str(path), "--batch", "2", "--prompt-len", "5",
                           "--new-tokens", "3", "--slo-ms", "60000"]) == 0
    finally:
        path.unlink()
    out = capsys.readouterr().out
    assert "packed 2 plan points of granite-8b" in out
    assert re.search(r"\] (\d+) requests in .* (\1)/\1 deadlines met", out)


@pytest.mark.parametrize("arch,extra", [
    ("resnet18", ["--batch", "2"]),
    ("granite-8b", ["--batch", "2", "--prompt-len", "6",
                    "--new-tokens", "3"]),
])
def test_fp_baseline(arch, extra, capsys):
    assert serve.main(["--arch", arch, *CPU, "--fp-baseline", *extra]) == 0
    out = capsys.readouterr().out
    assert "w_Q=FP" in out
    line = next(ln for ln in out.splitlines() if "roofline:" in ln)
    assert "host clock" in line and "% of roofline" in line
    assert " w16 " in out  # the bf16 layers, scored at the bf16 peak


def test_uniform_policy_flags(capsys):
    assert serve.main(["--arch", "resnet18", *CPU, "--w-bits", "4", "--k",
                       "2", "--channel-wise", "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "[w_Q=4 k=2]" in out and "roofline:" in out
    assert serve.main(["--arch", "granite-8b", *CPU, "--w-bits", "2",
                       "--batch", "1", "--prompt-len", "4",
                       "--new-tokens", "2"]) == 0
    assert "w_Q=2 k=2" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--frontier", str(FRONTIER), "--plan",
      str(PLANS / "resnet18_mixed.json")], "--frontier carries"),
    (["--frontier", str(FRONTIER), "--fp-baseline"], "--frontier carries"),
    (["--frontier", str(FRONTIER), "--w-bits", "2"], "--frontier carries"),
    (["--frontier", str(FRONTIER), "--channel-wise"], "--frontier carries"),
    (["--plan", str(PLANS / "resnet18_mixed.json"), "--fp-baseline"],
     "--plan carries"),
    (["--plan", str(PLANS / "resnet18_mixed.json"), "--k", "2"],
     "--plan carries"),
])
def test_conflicts_raise_as_in_reference(argv, match):
    """The JAX launcher refuses the same combinations with the same
    words (``repro.launch.serve.main``)."""
    from repro.launch import serve as jserve
    with pytest.raises(SystemExit, match=match):
        serve.main(["--arch", "resnet18", *CPU, *argv])
    with pytest.raises(SystemExit, match=match):
        jserve.main(["--arch", "resnet18", "--reduced", *argv])


def test_telemetry_validate_cli(tmp_path, capsys):
    from repro_torch.runtime import telemetry as tele
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    assert serve.main(["--arch", "resnet18", *CPU, "--batch", "1",
                       "--trace", str(trace), "--metrics-dump",
                       str(prom)]) == 0
    capsys.readouterr()
    assert tele._main(["validate", "--trace", str(trace), "--metrics",
                       str(prom)]) == 0
    assert "trace OK" in capsys.readouterr().out
    trace.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "a", "pid": 0, "tid": 0, "ts": 5, "dur": 1},
        {"ph": "X", "name": "b", "pid": 0, "tid": 0, "ts": 1, "dur": -1}]}))
    prom.write_text("repro_x 1\n")
    assert tele._main(["validate", "--trace", str(trace), "--metrics",
                       str(prom)]) == 1
    out = capsys.readouterr().out
    assert "not monotone" in out and "has no TYPE" in out
    with pytest.raises(SystemExit):
        tele._main(["validate"])
