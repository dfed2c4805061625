"""The port's static-analysis engine (`dorpatch_tpu_torch.analysis`): each
AST rule's torch reading positive and negative, parity with the JAX
package's engine on its shared rules' fixtures, suppression syntax, the
DP106 fixer, the concurrency wing and `static_lock_graph`, the shipped
tree clean under both gates, the CLI's exit codes, `--select`,
`--list-rules` and its json/SARIF output, and `--sanitize`'s lock watch
seeded from the static graph.

Mirrors `tests/test_analysis.py` and `tests/test_concurrency.py` case by
case. The shared rules (DP101, DP106, DP108, DP500-DP504) are
plain-Python in both packages: the JAX package's engine runs here on the
fixtures of `tests/fixtures/analysis/`, its package paths mapped to the
port's. Fixture sources of the torch readings are inline.
"""

import json
import pathlib
import re
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dorpatch_tpu_torch.analysis import (  # noqa: E402
    Finding, all_rules, analyze_file, analyze_paths, analyze_source)
from dorpatch_tpu_torch.analysis import concurrency as cc  # noqa: E402
from dorpatch_tpu_torch.analysis import lockwatch as lw  # noqa: E402
from dorpatch_tpu_torch.analysis.cli import main as cli_main  # noqa: E402
from dorpatch_tpu_torch.analysis.fix import fix_source  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
PKG = "dorpatch_tpu_torch"

AST_IDS = ("DP101", "DP102", "DP103", "DP104", "DP105", "DP106", "DP107",
           "DP108")
SHARED = ("DP101", "DP106", "DP108", "DP500", "DP501", "DP502", "DP503",
          "DP504")


def lint(src, logical=f"{PKG}/x.py", select=None):
    return analyze_source(src, logical_path=logical, select=select)


def ids(findings):
    return [f.rule_id for f in findings]


# ---------- the torch readings, positive and negative ----------

#: rule -> (logical path, positive source, negative source)
CASES = {
    "DP101": (f"{PKG}/attack.py",
              "def f(x):\n    print(x)\n",
              "from dorpatch_tpu_torch import observe\n"
              "def f(x):\n    observe.log(x)\n"),
    "DP102": (f"{PKG}/defense.py",
              "import torch\n"
              "from dorpatch_tpu_torch import observe\n"
              "class D:\n"
              "    def __init__(self):\n"
              "        self._p = observe.timed_first_call(self._prog, 'p')\n"
              "    def _prog(self, x):\n"
              "        n = int(x.sum())\n"
              "        torch.cuda.synchronize()\n"
              "        return x * n, x.max().item(), x.cpu(), x.tolist()\n",
              "import torch\n"
              "from dorpatch_tpu_torch import observe\n"
              "def prog(x):\n"
              "    return x * int(x.shape[0]) + float(2)\n"
              "def host(x):\n"
              "    return x.item()\n"
              "p = observe.timed_first_call(prog, 'p')\n"),
    "DP103": (f"{PKG}/attack.py",
              "import torch\n"
              "def f(x):\n"
              "    a = torch.rand(3)\n"
              "    b = torch.randn_like(x)\n"
              "    return x.uniform_(), a, b\n",
              "import torch\n"
              "def f(x, gen):\n"
              "    a = torch.rand(3, generator=gen)\n"
              "    return x.uniform_(generator=gen), a\n"),
    "DP104": (f"{PKG}/attack.py",
              "import torch\n"
              "from dorpatch_tpu_torch import utils\n"
              "torch.manual_seed(7)\n"
              "g = utils.generator(3, torch.device('cpu'))\n",
              "import torch\n"
              "from dorpatch_tpu_torch import utils\n"
              "def f(cfg):\n"
              "    return utils.generator(cfg.seed, torch.device('cpu'))\n"),
    "DP105": (f"{PKG}/attack.py",
              "import torch\n"
              "def f(x):\n    return x\n"
              "g = torch.compile(f)\n"
              "@torch.jit.script\n"
              "def h(x):\n    return x\n",
              "import torch\n"
              "from dorpatch_tpu_torch import observe\n"
              "def f(x):\n    return x\n"
              "g = torch.compile(f)\n"
              "prog = observe.timed_first_call(g, 'g')\n"
              "prog2 = observe.timed_first_call(torch.compile(f), 'h')\n"),
    "DP106": (f"{PKG}/attack.py",
              "import os\nimport torch\nX = torch.zeros(1)\n",
              "import os\nX = os.sep\n"),
    "DP107": (f"{PKG}/serve/service.py",
              "import numpy as np\nimport torch\n"
              "def dispatch(t, s):\n"
              "    a = t.item()\n"
              "    s.synchronize()\n"
              "    torch.cuda.synchronize()\n"
              "    return a, np.asarray(t), t.cpu()\n",
              "def marshal_response(t):\n"
              "    return t.cpu().numpy(), t.tolist()\n"),
    "DP108": (f"{PKG}/farm/worker.py",
              "class W:\n    def done(self):\n        self.completed += 1\n",
              "def drain(xs):\n    n = 0\n    for x in xs:\n        n += 1\n"
              "    return n\n"),
}


@pytest.mark.parametrize("rule_id", AST_IDS)
def test_rule_positive_fires(rule_id):
    logical, pos, _ = CASES[rule_id]
    found = [f for f in lint(pos, logical) if f.rule_id == rule_id]
    assert found, f"{rule_id} did not fire on its positive source"
    assert all(f.line > 0 for f in found)


@pytest.mark.parametrize("rule_id", AST_IDS)
def test_rule_negative_clean(rule_id):
    logical, _, neg = CASES[rule_id]
    found = [f for f in lint(neg, logical) if f.rule_id == rule_id]
    assert not found, f"false positives: {found}"


def test_dp102_catches_each_sync_kind():
    logical, pos, _ = CASES["DP102"]
    msgs = " | ".join(f.message for f in lint(pos, logical)
                      if f.rule_id == "DP102")
    for kind in ("int()", "torch.cuda.synchronize", ".item()", ".cpu()",
                 ".tolist()"):
        assert kind in msgs, f"missing {kind}: {msgs}"


def test_dp107_catches_each_sync_kind_and_exempts_marshal():
    logical, pos, _ = CASES["DP107"]
    found = [f for f in lint(pos, logical) if f.rule_id == "DP107"]
    msgs = " | ".join(f.message for f in found)
    for kind in (".item()", ".synchronize()", "torch.cuda.synchronize",
                 "numpy.asarray", ".cpu()"):
        assert kind in msgs, f"missing {kind}: {msgs}"
    src = ("def marshal_response(t):\n"
           "    def helper(x):\n"
           "        return x.item()\n"
           "    return t.cpu(), helper\n")
    found = lint(src, f"{PKG}/serve/service.py", ["DP107"])
    assert [f.line for f in found] == [3]


@pytest.mark.parametrize("logical,rule_id", [
    (f"{PKG}/observe/console.py", "DP101"),   # the sink itself
    ("tools/x.py", "DP101"),                  # outside the package
    (f"{PKG}/utils.py", "DP104"),             # the seed root
    ("tests/seeded.py", "DP104"),
    (f"{PKG}/pipeline.py", "DP107"),          # outside serve/
    (f"{PKG}/attack.py", "DP108"),            # outside serve/ and farm/
    ("tests/test_x.py", "DP103"),             # the test tree may draw
])
def test_path_scoped_exemptions(logical, rule_id):
    _, pos, _ = CASES[rule_id]
    assert not [f for f in lint(pos, logical) if f.rule_id == rule_id]


def test_dp104_only_package_root_utils_exempt():
    src = "import torch\ntorch.manual_seed(0)\n"
    assert lint(src, f"{PKG}/utils.py", ["DP104"]) == []
    assert ids(lint(src, f"{PKG}/models/utils.py", ["DP104"])) == ["DP104"]


def test_path_scoping_anchored_after_package_component():
    src = "import torch\ntorch.manual_seed(0)\n"
    assert ids(lint(src, f"data/tests/repo/{PKG}/attack.py",
                    ["DP104"])) == ["DP104"]
    assert ids(lint("print('x')\n", f"home/observe/repo/{PKG}/attack.py",
                    ["DP101"])) == ["DP101"]
    assert lint("print('x')\n", f"a/{PKG}/tools/p.py", ["DP101"]) == []


# ---------- parity with the JAX package's engine ----------

def _jax_engine():
    from dorpatch_tpu.analysis import engine as jengine
    from dorpatch_tpu.analysis import fix as jfix

    return jengine, jfix


def _norm(message):
    """The JAX package's DP502 and DP504 messages carry a "PR <n> "
    citation ("the PR <n> stranded-replica shape") that the port's leave
    out; the rest of each message is the same."""
    return re.sub(r"PR \d+ ", "", message)


FIXTURE_NAMES = sorted(p.name for p in FIXTURES.glob("*.py")
                       if re.match(r"dp(101|106|108|50[0-4])_", p.name)
                       or p.name == "suppressed.py")


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_shared_rules_match_the_jax_engine(name):
    """The same rule, line, col and message on the JAX package's fixture,
    linted as a file of either package's serve/ (the threaded, counted
    package both scopes reach)."""
    jengine, _ = _jax_engine()
    path = FIXTURES / name
    want = [(f.rule_id, f.line, f.col, _norm(f.message), f.fixable)
            for f in jengine.analyze_file(
                path, logical_path=f"dorpatch_tpu/serve/{name}")
            if f.rule_id in SHARED]
    got = [(f.rule_id, f.line, f.col, f.message, f.fixable)
           for f in analyze_file(path, logical_path=f"{PKG}/serve/{name}")
           if f.rule_id in SHARED]
    assert got == want
    if name.endswith("_pos.py"):
        assert got, f"{name} fired nothing"


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixer_byte_equal_to_the_jax_fixer(name):
    _, jfix = _jax_engine()
    src = (FIXTURES / name).read_text(encoding="utf-8")
    want = jfix.fix_source(src, name, f"dorpatch_tpu/{name}")
    assert fix_source(src, name, f"{PKG}/{name}") == want


def test_dp101_and_dp108_counts_match_the_fixtures():
    found = analyze_file(FIXTURES / "dp108_pos.py",
                         logical_path=f"{PKG}/serve/dp108_pos.py",
                         select=["DP108"])
    assert len(found) == 3
    (f,) = analyze_file(FIXTURES / "dp101_pos.py",
                        logical_path=f"{PKG}/dp101_pos.py", select=["DP101"])
    assert f.line == 5


# ---------- suppression syntax ----------

def test_noqa_wrong_code_does_not_suppress():
    src = "import torch\ntorch.manual_seed(7)  # noqa: DP101\n"
    assert ids(lint(src)) == ["DP104"]


def test_noqa_blanket_and_case_insensitive():
    assert lint("import torch\ntorch.manual_seed(7)  # noqa\n") == []
    assert lint("import torch\ntorch.manual_seed(7)  # noqa: dp104\n") == []


def test_syntax_error_is_a_dp000_finding():
    (f,) = analyze_source("def broken(:\n")
    assert f.rule_id == "DP000"


# ---------- DP106 --fix ----------

def test_fix_then_relint_clean_and_idempotent(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os, sys\nfrom typing import (\n    Dict,\n    List,\n"
                 ")\ndef f(d: Dict) -> int:\n    return sys.maxsize\n",
                 encoding="utf-8")
    assert cli_main([str(tmp_path), "--fix"]) == 0
    once = p.read_text(encoding="utf-8")
    assert analyze_paths([tmp_path], select=["DP106"]) == []
    assert "import sys" in once and "List" not in once
    assert cli_main([str(tmp_path), "--fix"]) == 0
    assert p.read_text(encoding="utf-8") == once


def test_fix_diff_dry_run(tmp_path, capsys):
    p = tmp_path / "m.py"
    p.write_text("import json\nX = 1\n", encoding="utf-8")
    assert cli_main([str(tmp_path), "--fix", "--diff"]) == 0
    out = capsys.readouterr()
    assert "-import json" in out.out and "would remove" in out.err
    assert p.read_text(encoding="utf-8") == "import json\nX = 1\n"


def test_fix_emptied_block_gets_pass():
    fixed, n = fix_source("def f():\n    import os\nX = 1\n", "t.py")
    assert n == 1 and "    pass\n" in fixed


# ---------- concurrency wing ----------

@pytest.mark.parametrize("logical", [
    f"{PKG}/serve/x.py", f"{PKG}/farm/x.py", f"{PKG}/observe/x.py",
    f"{PKG}/recert/x.py", f"{PKG}/gateway/x.py", f"{PKG}/parallel/x.py",
    f"{PKG}/backoff.py", f"{PKG}/chaos.py"])
def test_dp5xx_fire_across_the_threaded_packages(logical):
    found = analyze_file(FIXTURES / "dp501_pos.py", logical_path=logical)
    assert "DP501" in ids(found)


@pytest.mark.parametrize("logical", [f"{PKG}/attack.py", "tools/x.py",
                                     f"{PKG}/models/x.py"])
def test_dp5xx_scoped_to_the_threaded_packages(logical):
    found = analyze_file(FIXTURES / "dp501_pos.py", logical_path=logical)
    assert "DP501" not in ids(found)


def test_static_lock_graph_merges_package_edges(tmp_path):
    tree = tmp_path / PKG / "serve"
    tree.mkdir(parents=True)
    (tree / "a.py").write_text(
        (FIXTURES / "dp501_neg.py").read_text(encoding="utf-8"),
        encoding="utf-8")
    graph = cc.static_lock_graph([tmp_path / PKG])
    assert graph and all(isinstance(v, set) for v in graph.values())


def test_static_lock_graph_of_the_port_runs():
    graph = cc.static_lock_graph()
    assert isinstance(graph, dict)


# ---------- the shipped tree ----------

def test_shipped_tree_is_clean():
    """The gate: the port's package lints clean — every finding fixed or
    suppressed with a reason."""
    findings = analyze_paths([REPO / PKG])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_shipped_tree_concurrency_clean():
    assert cli_main(["--concurrency", str(REPO / PKG)]) == 0


# ---------- engine surface and CLI ----------

def test_rule_registry_stable_ids():
    rules = all_rules()
    assert [r.id for r in rules] == list(AST_IDS) + list(
        cc.CONCURRENCY_RULE_IDS)
    assert all(r.description for r in rules)
    assert [r.id for r in rules if r.fixable] == ["DP106"]


def test_finding_render_format():
    f = Finding(path="a/b.py", line=3, col=7, rule_id="DP104", message="m")
    assert f.render() == "a/b.py:3:7: DP104 m"


def test_cli_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("VALUE = 1\n")
    assert cli_main([str(clean)]) == 0
    assert capsys.readouterr().out == ""
    bad = tmp_path / "bad.py"
    bad.write_text("import json\nimport torch\ntorch.manual_seed(3)\n")
    assert cli_main([str(bad)]) == 1
    err = capsys.readouterr().err
    assert "finding(s)" in err
    assert cli_main(["--select", "DP999"]) == 2
    assert cli_main(["--diff"]) == 2
    assert cli_main(["--trace", "--fix"]) == 2
    assert cli_main(["--concurrency", "--trace"]) == 2


def test_cli_select_and_fixable(tmp_path, capsys):
    p = tmp_path / "f.py"
    p.write_text("import json\nimport torch\ntorch.manual_seed(3)\n")
    assert cli_main([str(p), "--select", "DP106"]) == 1
    out = capsys.readouterr().out
    assert "DP106" in out and "DP104" not in out
    assert cli_main([str(p), "--fixable"]) == 1
    out = capsys.readouterr().out
    assert "DP106" in out and "DP104" not in out


def test_cross_wing_select_is_usage_error(tmp_path, capsys):
    p = tmp_path / "f.py"
    p.write_text("import json\n")
    assert cli_main([str(p), "--select", "DP201"]) == 2
    assert "add --trace" in capsys.readouterr().err
    assert cli_main(["--trace", "--select", "DP106"]) == 2
    assert "drop --trace" in capsys.readouterr().err


def test_cli_list_rules_names_every_wing(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in AST_IDS + cc.CONCURRENCY_RULE_IDS + (
            "DP200", "DP201", "DP202", "DP203", "DP204", "DP205", "DP206",
            "DP208", "DP300", "DP301", "DP302", "DP303", "DP304", "DP305",
            "DP600", "DP603"):
        assert rid in out, rid
    # the rules with no torch reading are listed, and say so
    assert re.search(r"DP206 .*not applicable", out)
    assert re.search(r"DP601 .*not ported", out)


def test_cli_json_and_sarif(tmp_path, capsys):
    p = tmp_path / "f.py"
    p.write_text("import json\nimport torch\ntorch.manual_seed(3)\n")
    assert cli_main([str(p), "--format", "json"]) == 1
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert {r["rule"] for r in recs} == {"DP104", "DP106"}
    assert all(set(r) == {"rule", "path", "line", "col", "message",
                          "fixable"} for r in recs)
    assert cli_main([str(p), "--format", "sarif"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert [r["id"] for r in run["tool"]["driver"]["rules"]] == ["DP104",
                                                               "DP106"]
    assert run["tool"]["driver"]["rules"][0]["name"] == "literal-seed"
    assert {r["ruleId"] for r in run["results"]} == {"DP104", "DP106"}


def test_comms_and_compiled_cost_are_refused(capsys):
    assert cli_main(["--comms"]) == 2
    assert "not ported" in capsys.readouterr().err
    assert cli_main(["--baseline", "--baseline-cost", "compiled"]) == 2
    assert "no eager" in capsys.readouterr().err


def test_module_entry_point_gate_and_no_torch_import():
    """`python -m dorpatch_tpu_torch.analysis dorpatch_tpu_torch` exits 0
    on the shipped tree and 1 on a planted finding; linting loads no
    torch."""
    ok = subprocess.run(
        [sys.executable, "-c",
         "import sys; from dorpatch_tpu_torch.analysis.cli import main; "
         "rc = main(['dorpatch_tpu_torch']); "
         "sys.exit(rc or ('torch' in sys.modules and 3))"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    bad = subprocess.run(
        [sys.executable, "-m", "dorpatch_tpu_torch.analysis",
         "tests/fixtures/analysis"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert bad.returncode == 1 and "DP106" in bad.stdout


# ---------- --sanitize's lock watch ----------

def test_sanitizer_seeds_the_lock_watch_with_the_static_graph(monkeypatch):
    from dorpatch_tpu_torch.analysis import sanitize

    planted = {"_alock": {"_block"}}
    monkeypatch.setattr(cc, "static_lock_graph", lambda paths=None: planted)
    san = sanitize.Sanitizer(debug_nans=False, log_compiles=False,
                             recompile_budgets=False, lock_order=True)
    with san:
        watch = lw.active_watch()
        assert watch is san.lock_watch
        a, b = watch.lock("_alock"), watch.lock("_block")
        with a:        # the committed order passes
            with b:
                pass
        box = []

        def inverted():
            try:
                with b:
                    with a:
                        pass
            except lw.LockOrderViolation as e:
                box.append(e)

        t = threading.Thread(target=inverted)
        t.start()
        t.join(timeout=30)
        assert box, "the inversion of the static order was not caught"
    assert lw.active_watch() is None


def test_sanitizer_static_graph_is_the_ports():
    from dorpatch_tpu_torch.analysis import sanitize

    san = sanitize.Sanitizer(debug_nans=False, log_compiles=False,
                             recompile_budgets=False, lock_order=True)
    want = cc.static_lock_graph()
    assert want, "the port commits to no lock order?"
    assert san.lock_watch._static == want
