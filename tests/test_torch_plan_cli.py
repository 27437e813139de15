"""The rest of the port's plan module (``repro_torch.core.plan``) against
the JAX package's: frontier manifests (round trip, the same rejections as
``tests/test_slo.py``'s manifest tests), ``plan_footprint_report`` (the
Table III accounting, equal numbers), the plan helpers, and the command
line ``python -m repro_torch.core.plan validate|validate-frontier``, whose
exit codes and verdicts equal ``repro``'s on the shipped examples and on
broken copies.  An arch the port does not have yet exits 2, as an unknown
arch does in ``repro``, and says so.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core.precision import PrecisionPolicy as JPolicy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.plan import (FrontierEntry, FrontierManifest,  # noqa
                                   LayerPlan, PrecisionPlan)
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PLANS = sorted((ROOT / "examples" / "plans").glob("*.json"))
FRONTIERS = sorted((ROOT / "examples" / "frontiers").glob("*.json"))


def _plan(name, w, k, arch="tiny"):
    return PrecisionPlan(default=LayerPlan(w_bits=w, k=k), name=name,
                         arch=arch)


def _manifest(**kw):
    points = kw.pop("points", (
        FrontierEntry(plan=_plan("acc", 8, 4), rel_latency=1.0, error=0.0),
        FrontierEntry(plan=_plan("fast", 2, 2), rel_latency=0.2,
                      error=0.05)))
    return FrontierManifest(name="m", arch="tiny", points=points, **kw)


# --- manifests ---------------------------------------------------------------


def test_manifest_round_trip_equals_reference():
    m = _manifest()
    again = FrontierManifest.loads(m.dumps())
    assert again.point_names == ("acc", "fast") and again == m
    assert again.points[1].rel_latency == pytest.approx(0.2)
    assert jplan.FrontierManifest.loads(m.dumps()).dumps() == m.dumps()
    assert [n for n, _ in again.plans()] == ["acc", "fast"]


@pytest.mark.parametrize("points,match", [
    (((8, 4, 1.0, 0.1), (2, 2, 0.5, 0.0)), "error drops"),
    (((8, 4, 0.5, 0.0), (2, 2, 1.0, 0.0)), "rel_latency rises"),
])
def test_manifest_rejects_unordered(points, match):
    pts = tuple(FrontierEntry(plan=_plan(f"p{i}", w, k), rel_latency=r,
                              error=e)
                for i, (w, k, r, e) in enumerate(points))
    with pytest.raises(ValueError, match=match):
        _manifest(points=pts)


def test_manifest_rejects_names_arch_and_keys():
    with pytest.raises(ValueError, match="duplicate"):
        _manifest(points=(FrontierEntry(plan=_plan("a", 8, 4)),
                          FrontierEntry(plan=_plan("a", 2, 2),
                                        rel_latency=0.5)))
    with pytest.raises(ValueError, match="carry a name"):
        _manifest(points=(FrontierEntry(plan=_plan("", 8, 4)),))
    with pytest.raises(ValueError, match="targets arch"):
        FrontierManifest(name="m", arch="other", points=(
            FrontierEntry(plan=_plan("a", 8, 4, arch="tiny")),))
    with pytest.raises(ValueError, match="unknown frontier keys"):
        FrontierManifest.loads('{"version": 1, "name": "m", "arch": "a", '
                               '"points": [], "bogus": 1}')
    with pytest.raises(ValueError, match="at least one"):
        FrontierManifest(name="m", arch="a", points=())
    with pytest.raises(ValueError, match="must name their arch"):
        FrontierManifest(name="m", arch="", points=(
            FrontierEntry(plan=_plan("a", 8, 4, arch="")),))
    with pytest.raises(ValueError, match="unsupported frontier version"):
        FrontierManifest.loads('{"version": 2, "arch": "a", "points": []}')


def test_manifest_plan_path_relative_to_manifest(tmp_path):
    (tmp_path / "plans").mkdir()
    _plan("ref", 4, 4).save(tmp_path / "plans" / "p.json")
    obj = _manifest().to_json()
    obj["points"][1]["plan"] = "plans/p.json"
    (tmp_path / "f.json").write_text(json.dumps(obj))
    loaded = FrontierManifest.load(tmp_path / "f.json")
    assert loaded.point_names == ("acc", "ref")
    assert loaded.points[1].source == "plans/p.json"
    assert loaded.to_json()["points"][1]["plan"] == "plans/p.json"


def test_example_manifest_loads_like_reference():
    path = ROOT / "examples" / "frontiers" / "resnet18_frontier.json"
    mine, ref = tplan.validate_frontier_json(path), \
        jplan.validate_frontier_json(path)
    assert mine.dumps() == ref.dumps()
    assert [e.source for e in mine.points] == [e.source for e in ref.points]


def test_plan_helpers_equal_reference():
    for path in PLANS:
        mine, ref = PrecisionPlan.load(path), jplan.PrecisionPlan.load(path)
        assert mine.layer_names == ref.layer_names
        assert mine.distinct_wbits() == ref.distinct_wbits()
        assert mine.distinct_kvbits() == ref.distinct_kvbits()
    pol, jpol = PrecisionPolicy(inner_bits=2, k=2), JPolicy(inner_bits=2,
                                                           k=2)
    assert tplan.as_plan(pol).to_json() == jplan.as_plan(jpol).to_json()
    built = PrecisionPlan.build({"q": LayerPlan(4, 4)}, name="b")
    assert built.to_json() == jplan.PrecisionPlan.build(
        {"q": jplan.LayerPlan(4, 4)}, name="b").to_json()


def test_validate_kv_like_reference():
    plan = PrecisionPlan.load(ROOT / "examples/plans/granite_8b_mixed.json")
    with pytest.raises(ValueError, match="no decode KV cache"):
        plan.validate_kv([], arch="resnet18")
    with pytest.raises(ValueError, match="kv_bits set on layers"):
        plan.validate_kv(["l5.k"])
    plan.validate_kv(configs.get("granite-8b").kv_layer_names())


# --- footprints --------------------------------------------------------------


def _counts(arch):
    api, japi = configs.get(arch), jconfigs.get(arch)
    if api.family == "cnn":
        lp, cls = R.layer_param_counts(api.cfg), R.layer_classes(api.cfg)
        from repro.models import resnet as JR
        assert (lp, cls) == (JR.layer_param_counts(japi.cfg),
                             JR.layer_classes(japi.cfg))
        return lp, cls, None
    gemms = api.gemm_workload(1)
    lp = {g.name: g.k * g.n * g.count for g in gemms}
    cls = {g.name: g.layer_class for g in gemms}
    return lp, cls, api.kv_cache_workload()


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "resnet152",
                                  "granite-8b"])
def test_footprint_report_equals_reference(arch):
    lp, cls, kv = _counts(arch)
    policies = [(PrecisionPolicy(inner_bits=b, k=min(b, 4)),
                 JPolicy(inner_bits=b, k=min(b, 4))) for b in (1, 2, 4)]
    policies.append((PrecisionPolicy(quantize=False),
                     JPolicy(quantize=False)))
    for path in PLANS:
        plan = PrecisionPlan.load(path)
        if plan.arch == arch:
            policies.append((plan, jplan.PrecisionPlan.load(path)))
    for mine, ref in policies:
        for kw in ({}, {"kv_layers": kv, "kv_tokens": 4096}) if kv else ({},):
            if not kw and isinstance(mine, PrecisionPlan) \
                    and mine.kv_enabled():
                with pytest.raises(ValueError, match="KV-cache"):
                    tplan.plan_footprint_report(lp, cls, mine)
                continue
            assert tplan.plan_footprint_report(lp, cls, mine, **kw) == \
                jplan.plan_footprint_report(lp, cls, ref, **kw)


def test_kv_token_bytes_equals_reference():
    for bits in (None, 2, 4, 8):
        for k in (1, 2, 4, 8):
            assert tplan.kv_cache_token_bytes(bits, 8, 128, k) == \
                jplan.kv_cache_token_bytes(bits, 8, 128, k)


# --- the command line --------------------------------------------------------


def _run(main, args, capsys):
    """(exit code, printed text) of a CLI ``main`` run in process."""
    capsys.readouterr()
    rc = main([str(a) for a in args])
    out = capsys.readouterr()
    return rc, out.out + out.err


def _verdicts(text):
    return sorted(ln.split(":", 1)[0] for ln in text.splitlines()
                  if "] ok " in ln or "INVALID" in ln)


def _broken(tmp_path):
    """Broken copies of the shipped files: an unknown layer, a w_bits out
    of range, version 1 with kv keys, no arch, a kv entry on a CNN, an
    unordered frontier and one pointing at a missing plan."""
    mixed = json.loads((ROOT / "examples/plans/resnet18_mixed.json")
                       .read_text())
    granite = json.loads((ROOT / "examples/plans/granite_8b_mixed.json")
                         .read_text())
    out = {}

    def put(name, obj):
        p = tmp_path / name
        p.write_text(json.dumps(obj) if not isinstance(obj, str) else obj)
        out[name] = p
    put("unknown_layer.json", dict(mixed, layers=dict(
        mixed["layers"], s9b9c9={"w_bits": 2, "k": 2})))
    put("bad_bits.json", dict(mixed, default={"w_bits": 3, "k": 2}))
    put("v1_kv.json", dict(granite, version=1))
    put("no_arch.json", {k: v for k, v in mixed.items() if k != "arch"})
    put("cnn_kv.json", dict(mixed, layers=dict(
        mixed["layers"], s0b0c1={"w_bits": 2, "k": 2, "kv_bits": 4})))
    put("not_json.json", "{not json")
    put("unported.json", dict(mixed, arch="olmoe-1b-7b", layers={}))
    fr = json.loads((ROOT / "examples/frontiers/resnet18_frontier.json")
                    .read_text())
    fr["points"][1]["plan"] = str(ROOT / "examples/plans/resnet18_mixed.json")
    put("frontier_abs.json", fr)
    put("frontier_unordered.json", dict(fr, points=fr["points"][::-1]))
    put("frontier_missing.json", dict(fr, points=[
        dict(fr["points"][0]), {"plan": "nowhere.json"}]))
    put("frontier_unported.json", dict(fr, arch="yi-34b", points=[
        dict(fr["points"][0], plan=dict(fr["points"][0]["plan"],
                                        arch="yi-34b"))]))
    return out


@pytest.mark.parametrize("args", [
    ["validate", *PLANS],
    ["validate", "--arch", "resnet18",
     ROOT / "examples/plans/resnet18_mixed.json"],
    ["validate", "--arch", "granite-8b",
     ROOT / "examples/plans/resnet18_mixed.json"],
    ["validate-frontier", *FRONTIERS],
], ids=["plans", "arch-resnet18", "arch-mismatch", "frontiers"])
def test_cli_on_examples_equals_reference(args, capsys):
    rc, out = _run(tplan.main, args, capsys)
    jrc, jout = _run(jplan.main, args, capsys)
    assert (rc, _verdicts(out)) == (jrc, _verdicts(jout)), (out, jout)


def test_cli_on_broken_copies_equals_reference(tmp_path, capsys):
    files = _broken(tmp_path)
    for name, path in files.items():
        cmd = "validate-frontier" if name.startswith("frontier") \
            else "validate"
        rc, out = _run(tplan.main, [cmd, path], capsys)
        if "unported" in name:  # repro has the arch; the port says so
            assert rc == 2 and "not ported to repro_torch yet" in out, out
            continue
        jrc, jout = _run(jplan.main, [cmd, path], capsys)
        assert (rc, _verdicts(out)) == (jrc, _verdicts(jout)), (name, out,
                                                                jout)
        if name != "frontier_abs.json":
            assert rc != 0, name


def test_cli_schema_only_and_unknown_arch(tmp_path, capsys):
    files = _broken(tmp_path)
    assert tplan.main(["validate", "--schema-only",
                       str(files["no_arch.json"])]) == 0
    assert tplan.main(["validate", "--arch", "not-an-arch",
                       str(PLANS[0])]) == 2
    assert "unknown arch 'not-an-arch'" in capsys.readouterr().err
    assert tplan.main(["validate", "--arch", "olmoe-1b-7b",
                       str(PLANS[0])]) == 2
    assert "not ported" in capsys.readouterr().err


def test_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.core.plan",
                        "validate-frontier", *map(str, FRONTIERS)],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "[frontier] ok" in r.stdout
