"""The port's lint (``python -m repro_torch.analysis``): for each rule a
fixture it flags and one it passes, a pragma without a reason being a
finding itself, the CLI's ``--format json`` / ``--rules`` /
``--list-rules``, and the port plus ``chip_smoke.py`` scanning clean.
Fixtures are written to a temporary tree laid out as the repo is
(``src/repro_torch/...``), so the reference's lint never scans them."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import run_analysis
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID

ROOT = Path(__file__).resolve().parents[1]


def _tree(tmp_path, files):
    for rel, src in files.items():
        f = tmp_path / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(textwrap.dedent(src))
    return tmp_path


def _findings(tmp_path, files, rule, paths=("src/repro_torch",)):
    root = _tree(tmp_path, files)
    report = run_analysis([p for p in paths if (root / p).exists()], root=str(root),
                          rules=[rule])
    return [(f.file, f.line, f.rule) for f in report.findings]


FLAGGED = {
    "torch-host-sync": {"src/repro_torch/api/x.py": """\
        import torch

        def count(mask):
            return int(mask.sum().item())
        """},
    "torch-metric-discipline": {"src/repro_torch/core/x.py": """\
        import time

        def solve(stats):
            t0 = time.perf_counter()
            stats["solves"] += 1
            return t0
        """},
    "torch-bench-timing": {"chip_smoke.py": """\
        import time

        def phase(torch, fit):
            t0 = time.perf_counter()
            fit()
            return time.perf_counter() - t0
        """},
    "torch-kernel-plain": {
        "src/repro_torch/kernels/ref.py": """\
            def foo_ref(x):
                return x
            """,
        "src/repro_torch/kernels/bar.py": """\
            def bar_kernel(x):
                return x
            """,
        "src/repro_torch/kernels/ops.py": """\
            from repro_torch.kernels import ref

            def _on_cuda(*t):
                return False

            def foo(x):
                y = ref.foo_ref(x)
                if _on_cuda(x):
                    return x
                return y
            """},
}

PASSED = {
    "torch-host-sync": {
        "src/repro_torch/core/engine.py": """\
            def host_read(t):
                return t.tolist()

            def host_array(t):
                return t.cpu().numpy()
            """,
        "src/repro_torch/api/x.py": """\
            from repro_torch.core import engine

            def count(mask):
                return int(engine.host_read(mask.sum()))
            """,
        "tests_helper.py": """\
            def f(t):
                return t.item()
            """},
    "torch-metric-discipline": {
        "src/repro_torch/obs/clock.py": """\
            import time

            def now():
                return time.perf_counter()
            """,
        "src/repro_torch/launch/run.py": """\
            import time

            def main():
                return time.perf_counter()
            """,
        "src/repro_torch/data/x.py": """\
            class Manager:
                def get(self):
                    self.counters.hits += 1

                def register_metrics(self, registry=None):
                    pass
            """},
    "torch-bench-timing": {"chip_smoke.py": """\
        import time

        def phase(torch, fit):
            t0 = time.perf_counter()
            fit()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        def read(engine, fit):
            t0 = time.perf_counter()
            out = engine.host_read(fit())
            return out, time.perf_counter() - t0
        """},
    "torch-kernel-plain": {
        "src/repro_torch/kernels/ref.py": """\
            def foo_ref(x):
                return x

            def _helper_ref(x):
                return x
            """,
        "src/repro_torch/kernels/foo.py": """\
            def foo_kernel(x):
                return x
            """,
        "src/repro_torch/kernels/ops.py": """\
            from repro_torch.kernels import ref

            def _on_cuda(*t):
                return False

            def _plain(x):
                return ref._helper_ref(x)

            def foo(x):
                if _on_cuda(x):
                    return x
                return ref.foo_ref(x)

            def bar(x):
                if _on_cuda(x):
                    raise RuntimeError("no kernel")
                else:
                    y = _plain(x)
                return y
            """},
}


@pytest.mark.parametrize("rule", sorted(RULES_BY_ID))
def test_rule_flags_its_fixture(tmp_path, rule):
    paths = ("src/repro_torch", "chip_smoke.py")
    got = _findings(tmp_path, FLAGGED[rule], rule, paths)
    assert got and all(r == rule for _, _, r in got), got
    if rule == "torch-kernel-plain":
        assert {f for f, _, _ in got} == {"src/repro_torch/kernels/bar.py",
                                           "src/repro_torch/kernels/ops.py"}
    if rule == "torch-metric-discipline":
        assert [line for _, line, _ in got] == [4, 5]


@pytest.mark.parametrize("rule", sorted(RULES_BY_ID))
def test_rule_passes_its_fixture(tmp_path, rule):
    paths = ("src/repro_torch", "chip_smoke.py", "tests_helper.py")
    assert _findings(tmp_path, PASSED[rule], rule, paths) == []


def test_pragma_suppresses_and_a_reasonless_pragma_is_a_finding(tmp_path):
    files = {"src/repro_torch/api/x.py": """\
        def a(t):
            # allow[torch-host-sync]: a host tensor, read for a print
            return t.item()

        def b(t):
            return t.tolist()  # allow[torch-host-sync]:

        def c(t):
            return t.cpu()  # allow[host-sync-in-jit]: the reference's id does not count here
        """}
    root = _tree(tmp_path, files)
    report = run_analysis(["src/repro_torch"], root=str(root))
    got = sorted((f.line, f.rule) for f in report.findings)
    assert got == [(6, "bad-pragma"), (6, "torch-host-sync"), (9, "torch-host-sync")]
    assert [f.line for f in report.suppressed] == [3]
    assert not report.ok


def test_rule_ids_are_the_ports_own():
    assert {r.RULE_ID for r in ALL_RULES} == {
        "torch-host-sync", "torch-metric-discipline", "torch-bench-timing",
        "torch-kernel-plain"}
    assert all(r.DOC for r in ALL_RULES)


def _cli(*args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_json_rules_and_list(tmp_path):
    root = _tree(tmp_path, FLAGGED["torch-host-sync"])
    r = _cli("--format", "json", "--root", str(root), "src/repro_torch")
    assert r.returncode == 1, r.stderr
    out = json.loads(r.stdout)
    assert not out["ok"] and out["files"] == 1
    assert [f["rule"] for f in out["findings"]] == ["torch-host-sync"]
    r = _cli("--rules", "torch-kernel-plain", "--root", str(root), "src/repro_torch")
    assert r.returncode == 0 and "0 finding(s)" in r.stdout
    r = _cli("--list-rules")
    assert r.returncode == 0
    assert [line.split()[0] for line in r.stdout.splitlines()] == [
        rule.RULE_ID for rule in ALL_RULES]


def test_the_port_and_chip_smoke_scan_clean():
    r = _cli("src/repro_torch", "chip_smoke.py")
    assert r.returncode == 0, r.stdout[-3000:]
    assert "0 finding(s)" in r.stdout
