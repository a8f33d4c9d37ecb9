"""The port's rplint (``randomprojection_tpu_torch.analysis``) against the
JAX package's.

Every fixture in ``tests/rplint_fixtures/`` goes through both linters
under the reference tests' virtual relpaths (``ops/pallas_kernels.py``
and ``backends/jax_backend.py`` under their port names, the fixture's
``randomprojection_tpu`` imports under the port's package name), each
with its own package's event registry and ``DEGRADED_EVENTS``: the
findings (rule, line, message, suppression, severity) are the same for
every rule but RP07, which the port rewrote.  Inline torch sources hold
the changed rules: RP03/RP09 see torch's host syncs, RP05 torch's global
RNG, RP07 the asynchronous-copy discipline (each leg beside a clean
twin).  Also: the port's tree lints clean with every pragma reasoned and
none stale, the exit codes, the ``--json`` record's keys, baselines read
across the two packages, SARIF's structure, ``--jobs`` determinism, the
scope sets naming real modules, and an import that pulls in neither
torch, JAX nor the reference package.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from randomprojection_tpu.analysis import rplint as ref
from randomprojection_tpu_torch import cli
from randomprojection_tpu_torch.analysis import rplint

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "rplint_fixtures"
# the reference module each port module stands for
PORT_NAME = {
    "ops/pallas_kernels.py": "ops/fused_kernels.py",
    "backends/jax_backend.py": "backends/torch_backend.py",
}
# the virtual relpaths the reference's tests lint fixtures under, plus a
# module of every other scope set
RELPATHS = (
    None, "streaming.py", "ops/fixture.py", "durable.py", "ann/lsh.py",
    "ops/pallas_kernels.py", "backends/jax_backend.py", "models/sketch.py",
    "utils/telemetry.py", "utils/trace_report.py", "serving/server.py",
)


def _registry(mod, pkg):
    root = REPO / pkg / "utils"
    reg = mod.load_event_registry((root / "telemetry.py").read_text())
    degraded, _line = mod.load_degraded_events(
        (root / "trace_report.py").read_text())
    return reg, degraded


def _key(findings):
    return [(f.rule, f.line, f.message, f.suppressed, f.severity)
            for f in findings
            if f.rule != "RP07"
            and not f.message.startswith("stale pragma: allow[RP07]")]


def _both(src, rel, ref_ctx, port_ctx):
    ref_reg, ref_deg = ref_ctx
    port_reg, port_deg = port_ctx
    a = ref.lint_source(src, rel, registry=ref_reg, degraded=ref_deg)
    b = rplint.lint_source(
        src.replace("randomprojection_tpu", "randomprojection_tpu_torch"),
        PORT_NAME.get(rel, rel), registry=port_reg, degraded=port_deg)
    return a, b


def test_the_two_registries_are_equal():
    ref_reg, ref_deg = _registry(ref, "randomprojection_tpu")
    port_reg, port_deg = _registry(rplint, "randomprojection_tpu_torch")
    assert port_reg.events == ref_reg.events
    assert port_reg.families == ref_reg.families
    assert port_deg == ref_deg


@pytest.mark.parametrize(
    "fixture", sorted(p.name for p in FIXTURES.glob("*.py")))
def test_fixture_findings_equal_the_reference(fixture):
    src = (FIXTURES / fixture).read_text()
    real = (_registry(ref, "randomprojection_tpu"),
            _registry(rplint, "randomprojection_tpu_torch"))
    toy = ((ref.EventRegistry({"GOOD": "good.event"}, ("fam.",), {}), None),
           (rplint.EventRegistry({"GOOD": "good.event"}, ("fam.",), {}),
            None))
    none = ((None, None), (None, None))
    seen = 0
    for rel in RELPATHS:
        for ref_ctx, port_ctx in (real, toy, none):
            a, b = _both(src, rel or fixture, ref_ctx, port_ctx)
            assert _key(b) == _key(a), (rel, ref_ctx is real[0])
            seen += len(_key(a))
    # every fixture trips a compared rule somewhere; the RP07 fixture
    # holds Pallas DMA code only, which the port's RP07 does not check
    assert seen > 0 or fixture == "rp07_bad.py"


# -- the rules the port changed ----------------------------------------------

_SYNC_LOOP = '''\
import torch


def drain(batches):
    out = []
    for y in batches:
        out.append(y.sum().item())
        out.append(y.tolist())
        out.append(y.cpu())
        out.append(y.numpy())
        torch.cuda.synchronize()
    return out


def once(y, ev):
    ev.synchronize()
    return y.item()
'''


def test_rp03_sees_torch_syncs_in_hot_loops_only():
    found = [f for f in rplint.lint_source(_SYNC_LOOP, "streaming.py")
             if f.rule == "RP03"]
    assert [f.line for f in found] == [7, 8, 9, 10, 11]
    msgs = " | ".join(f.message for f in found)
    for what in (".item()", ".tolist()", ".cpu()", ".numpy()",
                 "torch.cuda.synchronize()"):
        assert what in msgs
    assert "pinned non_blocking copy" in msgs
    # outside the hot set the same loop is not RP03's business
    assert not [f for f in rplint.lint_source(_SYNC_LOOP, "jl.py")
                if f.rule == "RP03"]


def test_rp03_keeps_the_reference_syncs():
    src = ("import numpy as np\n"
           "def f(ys):\n"
           "    for y in ys:\n"
           "        np.asarray(y)\n"
           "        float(y.sum())\n"
           "        float(y)\n")
    found = [f for f in rplint.lint_source(src, "tiering.py")
             if f.rule == "RP03"]
    assert [(f.line, f.message[:17]) for f in found] == [
        (4, "np.asarray inside"), (5, "float() on an exp")]


def test_rp09_sees_a_torch_sync_one_call_away(tmp_path):
    helper = ("def fetch(y):\n"
              "    return y.cpu()\n")
    hot = ("from randomprojection_tpu_torch.helpers import fetch\n"
           "from randomprojection_tpu.helpers import fetch as ref_fetch\n"
           "def serve(ys):\n"
           "    for y in ys:\n"
           "        fetch(y)\n"
           "        ref_fetch(y)\n")
    root = tmp_path / "randomprojection_tpu_torch"
    root.mkdir()
    (root / "helpers.py").write_text(helper)
    (root / "loadgen.py").write_text(hot)
    rec = rplint.lint_package(str(root), jobs=1)
    found = [f for f in rec["findings"] if f["rule"] == "RP09"]
    # the full package name resolves; the reference's, a prefix of it,
    # is another package's module
    assert [(f["path"], f["line"]) for f in found] == [("loadgen.py", 5)]
    assert "helpers.py:2" in found[0]["message"]
    assert ".cpu()" in found[0]["message"]


def test_rp05_flags_torch_global_rng_in_ops():
    src = ("import torch\n"
           "def draw(n, gen):\n"
           "    torch.manual_seed(0)\n"
           "    a = torch.rand(n)\n"
           "    b = torch.randn(n, n)\n"
           "    c = torch.randint(0, 9, (n,))\n"
           "    d = torch.randperm(n)\n"
           "    e = torch.bernoulli(a)\n"
           "    f = torch.normal(a, 1.0)\n"
           "    g = torch.rand(n, generator=gen)\n"
           "    h = torch.Generator().manual_seed(3)\n"
           "    return a, b, c, d, e, f, g, h\n")
    found = [f for f in rplint.lint_source(src, "ops/threefry.py")
             if f.rule == "RP05"]
    assert [f.line for f in found] == [3, 4, 5, 6, 7, 8, 9]
    assert "torch.manual_seed()" in found[0].message
    assert all("generator=" in f.message for f in found[1:])
    assert not rplint.lint_source(src, "models/sketch.py")  # outside ops/


_RP07 = '''\
import torch
from randomprojection_tpu_torch.ops.staging import StagedBatch, stage_upload


def up_no_event(t, dev):
    x = t.to(dev, non_blocking=True)
    return x


def up_with_event(t, dev):
    x = t.to(dev, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return x, done


def up_event_on_one_branch(t, dev, flag):
    x = t.to(dev, non_blocking=True)
    if flag:
        torch.cuda.Event().record()
    return x


def up_in_carrier(t, dev, ev):
    x = t.to(dev, non_blocking=True)
    return StagedBatch(x, ev)


def read_before_wait(t, dev):
    s = stage_upload(t, dev)
    y = s.tensor + 1
    s.wait()
    return y


def read_after_wait(t, dev):
    s = stage_upload(t, dev)
    s.wait()
    return s.tensor + 1


def d2h_read_early(y):
    host = torch.empty(y.shape, pin_memory=True)
    host.copy_(y, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    out = host.numpy()
    done.synchronize()
    return out


def d2h_read_late(y):
    host = torch.empty(y.shape, pin_memory=True)
    host.copy_(y, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy()


def d2h_handed_on(self, y):
    host = y.pin_memory()
    host.copy_(y, non_blocking=True)
    self.done = torch.cuda.Event()
    self.done.record()
    self.host = host
'''


def test_rp07_async_copy_legs_and_their_clean_twins():
    found = [f for f in rplint.lint_source(_RP07, "streaming.py")
             if f.rule == "RP07"]
    by_line = {f.line: f.message for f in found}
    assert sorted(by_line) == [6, 18, 31, 47]
    assert "without an event recorded" in by_line[6]
    assert "without an event recorded" in by_line[18]
    assert "before the batch's .wait()" in by_line[31]
    assert "'host'" in by_line[47] and "synchronize()" in by_line[47]
    # RP07 runs on its modules only
    assert not [f for f in rplint.lint_source(_RP07, "jl.py")
                if f.rule == "RP07"]


def test_rp07_rules_text_names_the_new_discipline():
    assert "non_blocking" in rplint.RULES["RP07"]
    assert "VMEM-budget leg is dropped" in rplint.RULES["RP07"]
    assert set(rplint.RULES) == set(ref.RULES)


# -- the port's tree and the CLI ---------------------------------------------


@pytest.fixture(scope="module")
def tree():
    return rplint.lint_package(jobs=2)


def test_the_port_tree_lints_clean(tree):
    bad = [f for f in tree["findings"] if not f["suppressed"]]
    assert tree["ok"] and not bad, bad
    assert not [f for f in tree["findings"] if f["rule"] == "RP00"]
    assert all(f["reason"] for f in tree["findings"] if f["suppressed"])
    assert tree["files"] >= 55
    assert tree["root"] == str(REPO / "randomprojection_tpu_torch")


def test_the_degraded_drift_pragma_covers_the_ladder_events(tree):
    sup = [f for f in tree["findings"]
           if f["rule"] == "RP14" and f["path"] == "utils/trace_report.py"]
    assert sorted(f["message"].split()[2].rstrip(",") for f in sup) == [
        "EVENTS.BACKEND_VMEM_OOM_RETRY", "EVENTS.KERNEL_DMA_FALLBACK",
        "EVENTS.SIMHASH_TOPK_BLOCK_CLAMP",
        "EVENTS.SIMHASH_TOPK_DENSE_FALLBACK",
        "EVENTS.TOPK_KERNEL_SCAN_FALLBACK", "EVENTS.TOPK_KERNEL_VMEM_RETRY"]
    assert all("No VMEM-OOM ladders" in f["reason"] for f in sup)


def test_a_drift_pragma_that_covers_nothing_is_stale(tmp_path):
    root = tmp_path / "randomprojection_tpu_torch"
    (root / "utils").mkdir(parents=True)
    (root / "utils" / "telemetry.py").write_text(
        "class EVENTS:\n    A = 'a.event'\n")
    (root / "utils" / "trace_report.py").write_text(
        "from randomprojection_tpu_torch.utils.telemetry import EVENTS\n"
        "# rplint: allow[RP14] — test: nothing to cover\n"
        "DEGRADED_EVENTS = (EVENTS.A,)\n")
    (root / "emitter.py").write_text(
        "from randomprojection_tpu_torch.utils import telemetry\n"
        "from randomprojection_tpu_torch.utils.telemetry import EVENTS\n"
        "telemetry.emit(EVENTS.A)\n")
    rec = rplint.lint_package(str(root), jobs=1)
    assert [(f["rule"], f["line"]) for f in rec["findings"]] == [
        ("RP00", 2)]
    assert "stale pragma" in rec["findings"][0]["message"]
    # without the emitter the pragma suppresses the reverse-leg finding
    (root / "emitter.py").unlink()
    rec = rplint.lint_package(str(root), jobs=1)
    assert rec["ok"] and [(f["rule"], f["suppressed"])
                          for f in rec["findings"]] == [("RP14", True)]


def test_the_record_has_the_reference_keys(tree, tmp_path):
    seeded = tmp_path / "x.py"
    seeded.write_text("import queue\nq = queue.Queue()\n")
    mine = rplint.lint_package(files=[str(seeded)], jobs=1)
    theirs = ref.lint_package(files=[str(seeded)], jobs=1)
    assert set(tree) == set(theirs) == set(mine)
    assert mine["rplint"] == theirs["rplint"] == 4
    assert mine["findings"] == theirs["findings"]
    assert set(mine["findings"][0]) == set(theirs["findings"][0])


def test_baselines_read_across_the_two_packages(tmp_path):
    seeded = tmp_path / "x.py"
    seeded.write_text("import queue\nq = queue.Queue()\n")
    mine = rplint.lint_package(files=[str(seeded)], jobs=1)
    theirs = ref.lint_package(files=[str(seeded)], jobs=1)
    assert ref.diff_baseline(mine, theirs) == rplint.diff_baseline(
        theirs, mine) == {"matched": 1, "new": [], "stale": 0, "ok": True}
    # a record with a finding the other lacks is new to it
    assert not ref.diff_baseline(mine, {"findings": []})["ok"]
    assert rplint.diff_baseline(theirs, {"findings": []})["new"] == \
        theirs["findings"]


def test_sarif_has_the_reference_structure(tmp_path):
    seeded = tmp_path / "x.py"
    seeded.write_text(
        "import queue\n"
        "q = queue.Queue()\n"
        "# rplint: allow[RP04] — test: bounded upstream\n"
        "q2 = queue.Queue()\n")
    mine = rplint.to_sarif(rplint.lint_package(files=[str(seeded)], jobs=1))
    theirs = ref.to_sarif(ref.lint_package(files=[str(seeded)], jobs=1))

    def shape(x):
        if isinstance(x, dict):
            return {k: shape(v) for k, v in x.items()}
        if isinstance(x, list):
            return [shape(v) for v in x]
        return type(x).__name__

    assert shape(mine) == shape(theirs)
    assert mine["runs"][0]["results"] == theirs["runs"][0]["results"]
    assert [r["id"] for r in mine["runs"][0]["tool"]["driver"]["rules"]] == \
        [r["id"] for r in theirs["runs"][0]["tool"]["driver"]["rules"]]


def test_jobs_are_deterministic():
    root = rplint.package_root()
    files = [os.path.join(root, *rel.split("/"))
             for rel in ("models/sketch.py", "utils/telemetry.py",
                         "streaming.py", "ann/lsh.py", "tiering.py",
                         "ops/probe_kernels.py")]
    serial = rplint.lint_package(files=files, jobs=1)
    pooled = rplint.lint_package(files=files, jobs=3)
    assert serial["findings"] == pooled["findings"]
    assert serial["counts"] == pooled["counts"]
    assert serial["files"] == pooled["files"] == len(files)


def test_rule_scope_sets_name_real_modules():
    root = Path(rplint.package_root())
    scoped = set()
    for group in (rplint.HOT_MODULES, rplint.PIPELINE_MODULES,
                  rplint.CONCURRENCY_MODULES, rplint.RP13_MODULES,
                  rplint.RP14_MODULES, rplint.ASYNC_COPY_MODULES):
        scoped.update(group)
    missing = [rel for rel in sorted(scoped)
               if not (root / rel).exists()]
    assert scoped and missing == [], missing
    # the reference's sets, module for module under the port's names
    for name in ("HOT_MODULES", "PIPELINE_MODULES", "CONCURRENCY_MODULES",
                 "RP13_MODULES", "RP14_MODULES"):
        assert getattr(rplint, name) == tuple(
            PORT_NAME.get(r, r) for r in getattr(ref, name)), name
    assert {PORT_NAME.get(r, r) for r in ref.KERNEL_BUDGET_FNS} <= set(
        rplint.ASYNC_COPY_MODULES)


def test_cli_exit_codes(tmp_path, capsys):
    assert cli.main(["lint", "--jobs", "2"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("rplint: clean — ") and "suppressed" in out
    seeded = tmp_path / "seeded.py"
    seeded.write_text("import queue\nq = queue.Queue()\n")  # RP04
    assert cli.main(["lint", str(seeded)]) == 1
    assert "RP04" in capsys.readouterr().out
    assert cli.main(["lint", str(tmp_path / "missing.py")]) == 2
    assert "internal error" in capsys.readouterr().err
    assert cli.main(["lint", "--json", str(seeded)]) == 1
    rec = json.loads(capsys.readouterr().out)
    assert rec["counts"] == {"RP04": 1} and rec["ok"] is False


def test_update_baseline_then_clean(tmp_path, capsys):
    seeded = tmp_path / "seeded.py"
    seeded.write_text("import queue\nq = queue.Queue()\n")
    base = tmp_path / "base.json"
    assert cli.main(["lint", "--baseline", str(base), "--update-baseline",
                     str(seeded)]) == 0
    assert json.loads(base.read_text())["counts"] == {"RP04": 1}
    assert cli.main(["lint", "--baseline", str(base), str(seeded)]) == 0
    capsys.readouterr()
    # the reference reads the port's baseline file as its own
    assert ref.main(["--baseline", str(base), str(seeded)]) == 0


def test_import_pulls_in_no_torch_jax_or_reference():
    code = ("import sys, randomprojection_tpu_torch.analysis as a\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'randomprojection_tpu')]\n"
            "assert not bad, bad\n"
            "assert sorted(a.__all__) == sorted(["
            "'RULES', 'Finding', 'check_registry_drift', 'diff_baseline', "
            "'lint_package', 'lint_source', 'load_event_registry', 'main', "
            "'to_sarif'])\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
