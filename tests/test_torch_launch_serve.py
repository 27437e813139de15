"""The port's entry point, ``python -m repro_torch.launch.serve``, on the
CPU at reduced sizes: both architectures, plain and speculative
generation, the telemetry files it writes (held to the JAX package's
validators), and the flags it refuses.
"""
import json
import os
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


@pytest.mark.parametrize("argv,match", [
    (["--arch", "granite-8b", "--spec-decode", "4"], "--draft-plan"),
    (["--arch", "resnet18", "--spec-decode", "4", "--draft-plan",
      str(PLANS / "granite_8b_draft_w2.json")], "LM archs"),
])
def test_refused_combinations(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(argv + CPU)


@pytest.mark.parametrize("flag", ["--mesh", "--frontier", "--ckpt-dir",
                                  "--w-bits"])
def test_flags_waiting_for_modules_are_absent(flag, capsys):
    with pytest.raises(SystemExit) as err:
        serve.main(["--arch", "resnet18", *CPU, flag, "1"])
    assert err.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


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
