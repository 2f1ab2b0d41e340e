"""The port's lint engine, config and CLI (``repro_torch.analysis``) against
the reference's (``repro.analysis``).

The port's five rules, given the reference's scopes through
``config.options``, report the reference rules' ``(location, line)``
findings on this repo and on the reference's fixture sources
(``tests/test_analysis.py``); ``kernel-containment`` is held against
``pallas-containment`` on fixture trees of the same shape.  The TOML
parsers, ``allowed`` and ``Finding`` agree.  The port's own pass over the
repo is clean, and each rule bites on a fixture.
"""

import json
import pathlib

import pytest

from repro.analysis import config as jconfig
from repro.analysis.findings import Finding as JFinding
from repro.analysis.lint import run_lint as jrun_lint
from repro.analysis.rules.pallas_containment import PallasContainmentRule
from repro.analysis.rules.register_path_decl import \
    RegisterPathDeclRule as JRegisterPathDeclRule
from repro.analysis.rules.retired_names import \
    RetiredNamesRule as JRetiredNamesRule
from repro.analysis.rules.thin_cli import ThinCliRule as JThinCliRule
from repro.analysis.rules.wall_clock import WallClockRule as JWallClockRule
from repro_torch.analysis import config as tconfig
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.rules import (
    ALL_RULES,
    KernelContainmentRule,
    RegisterPathDeclRule,
    RetiredNamesRule,
    ThinCliRule,
    WallClockRule,
)

REPO = pathlib.Path(__file__).resolve().parent.parent

#: The reference's scopes, as options of the port's rules.
REFERENCE_SCOPES = {
    "wall-clock": {"prefix": "src/repro/serving/"},
    "register-path-decl": {"prefix": "src/repro/"},
    "thin-cli": {"paths": ["src/repro/launch/trigger_serve.py",
                           "src/repro/launch/serve.py"],
                 "forbidden": ["jax", "numpy", "jax.numpy"],
                 "allowed_prefix": "repro.serving"},
    "kernel-containment": {"prefix": "src/repro/kernels/"},
}

#: (port rule, reference rule) pairs that share a rule id.
PAIRS = {
    "wall-clock": (WallClockRule(), JWallClockRule()),
    "register-path-decl": (RegisterPathDeclRule(), JRegisterPathDeclRule()),
    "thin-cli": (ThinCliRule(), JThinCliRule()),
    "retired-names": (RetiredNamesRule(), JRetiredNamesRule()),
}


def _pairs(findings):
    return [(f.location, f.line) for f in findings]


def _port(root, rule, options=None, allow=None):
    cfg = tconfig.AnalysisConfig(allow=dict(allow or {}),
                                 options=dict(options or {}))
    return run_lint(root, [rule], cfg)


def _ref(root, rule, options=None):
    return jrun_lint(root, [rule],
                     jconfig.AnalysisConfig(options=dict(options or {})))


# ---------------------------------------------------------------------------
# Parity with the reference's rules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule_id,scope", [
    ("wall-clock", "reference"), ("wall-clock", "port"),
    ("register-path-decl", "reference"), ("register-path-decl", "port"),
    ("thin-cli", "reference"), ("thin-cli", "port"),
    ("retired-names", "repo"),
])
def test_port_rules_match_the_reference_on_the_repo(rule_id, scope):
    """No allowlist on either side: the rules' raw findings."""
    port_rule, ref_rule = PAIRS[rule_id]
    if scope == "reference":
        port_opts, ref_opts = {rule_id: REFERENCE_SCOPES[rule_id]}, {}
    elif scope == "port":
        ref_opts = {"wall-clock": {"prefix": "src/repro_torch/serving/"},
                    "register-path-decl": {"prefix": "src/repro_torch/"},
                    "thin-cli": {"paths": [
                        "src/repro_torch/launch/trigger_serve.py",
                        "src/repro_torch/launch/serve.py"]}}
        port_opts, ref_opts = {}, {rule_id: ref_opts[rule_id]}
    else:
        port_opts = ref_opts = {}
    got = _pairs(_port(REPO, port_rule, port_opts))
    want = _pairs(_ref(REPO, ref_rule, ref_opts))
    assert got == want
    if rule_id == "wall-clock":
        assert got                    # the seam owners' clock reads
    if rule_id == "retired-names":
        assert {loc for loc, _ in got} >= {"ruff.toml", "CHANGES.md"}


#: The reference's fixture sources (``tests/test_analysis.py``'s
#: ``tmp_path`` cases, and a fat CLI), by rule: {relative path: text}.
REF_FIXTURES = {
    "wall-clock": {"src/repro/serving/hot.py": (
        "import time\n"
        "from time import perf_counter\n"
        "def step(clock=time.monotonic):   # seam: attribute ref, legal\n"
        "    t0 = clock()\n"
        "    t1 = time.time()              # direct call: finding\n"
        "    t2 = perf_counter()           # direct call: finding\n"
        "    return t1 - t0 + t2\n")},
    "register-path-decl": {"src/repro/core/newpath.py": (
        "from repro.core.paths import register_path\n"
        "@register_path(name='mystery', fused_level='none')\n"
        "def forward_mystery(p, cfg, x):\n"
        "    return x\n")},
    # the retired names built by concatenation, as the rules build them
    "retired-names": {"sanctioned.md": "history: removed FORWARD" "_FNS\n",
                      "offender.py": "PALLAS" "_PATHS = {}\n"},
    "thin-cli": {"src/repro/launch/serve.py": (
        '"""A CLI that grew."""\n'
        "import numpy as np\n"
        "from repro.core import paths\n"
        "from repro.serving import engine\n"
        "def helper():\n"
        "    return 1\n"
        "for i in range(2):\n"
        "    pass\n"
        "def main():\n"
        "    if np.ones(1)[0]:\n"
        "        for _ in range(2):\n"
        "            pass\n"), "src/repro/launch/trigger_serve.py": (
        "import jax\n"
        "def main():\n"
        "    with open('x') as f:\n"
        "        return f\n"
        "if __name__ == '__main__':\n"
        "    main()\n")},
}


def _tree(root, files):
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


@pytest.mark.parametrize("rule_id", list(REF_FIXTURES))
def test_port_rules_match_the_reference_on_its_fixtures(tmp_path, rule_id):
    _tree(tmp_path, REF_FIXTURES[rule_id])
    port_rule, ref_rule = PAIRS[rule_id]
    got = _port(tmp_path, port_rule, {rule_id: REFERENCE_SCOPES.get(
        rule_id, {})})
    want = _ref(tmp_path, ref_rule)
    assert _pairs(got) == _pairs(want) and got
    assert {f.rule for f in got} == {rule_id}


#: The same tree twice: a kernel call outside and inside the kernels
#: package, and one in a test, at the same lines.
_CONTAINMENT_TREE = {
    "rogue.py": "{imp}\n\nout = {call}\n",
    "src/repro/serving/hot.py": "x = 1\n{imp}\ny = {call}\n",
    "src/repro/kernels/ok.py": "{imp}\nout = {call}\n",
    "tests/test_x.py": "{imp}\n\n\nz = {call}\n",
}


@pytest.mark.parametrize("variant", [
    dict(imp="import ctypes", call="ctypes.CDLL('lib.so')"),
    dict(imp="from ctypes import cdll", call="cdll.LoadLibrary('lib.so')"),
    dict(imp="from torch.utils import cpp_extension",
         call="cpp_extension.load_inline('k', '')"),
], ids=["CDLL", "LoadLibrary", "load_inline"])
def test_kernel_containment_matches_pallas_containment(tmp_path, variant):
    pallas = dict(imp="import jax.experimental.pallas as pl",
                  call="pl.pallas_call(lambda r: None, grid=(1,))")
    _tree(tmp_path / "ref", {k: v.format(**pallas)
                             for k, v in _CONTAINMENT_TREE.items()})
    _tree(tmp_path / "port", {k: v.format(**variant)
                              for k, v in _CONTAINMENT_TREE.items()})
    got = _port(tmp_path / "port", KernelContainmentRule(),
                {"kernel-containment": REFERENCE_SCOPES["kernel-containment"]})
    want = _ref(tmp_path / "ref", PallasContainmentRule())
    assert _pairs(got) == _pairs(want)
    assert [loc for loc, _ in _pairs(got)] == [
        "rogue.py", "src/repro/serving/hot.py", "tests/test_x.py"]


# ---------------------------------------------------------------------------
# Config and Finding.
# ---------------------------------------------------------------------------

_TOML_CASES = {
    "reference analysis.toml": (REPO / "analysis.toml").read_text(),
    "port analysis.toml": tconfig.CONFIG_PATH.read_text(),
    "multiline": ("# header comment\n"
                  "[rules.some-rule]\n"
                  "allow = [\n"
                  '    "a.py",   # trailing comment\n'
                  '    "b/*.py",\n'
                  "]\n"
                  "limit = 5\n"
                  "strict = true\n"),
}


@pytest.mark.parametrize("case", list(_TOML_CASES))
def test_toml_subset_parsers_agree(case):
    text = _TOML_CASES[case]
    got = tconfig._parse_toml_subset(text)
    assert got == jconfig._parse_toml_subset(text)
    assert got["rules"]


@pytest.mark.parametrize("text", ["[rules.x]\nallow = {oops}\n",
                                  "[rules.x]\nallow = [\n\"a\",\n",
                                  "[rules.x]\nnot a pair\n"])
def test_toml_subset_parsers_reject_the_same_garbage(text):
    with pytest.raises(ValueError):
        jconfig._parse_toml_subset(text)
    with pytest.raises(ValueError):
        tconfig._parse_toml_subset(text)


def test_allowed_and_finding_match_the_reference():
    allow = {"r": ["docs/*.md", "exact.py", "src/**"]}
    port, ref = tconfig.AnalysisConfig(allow=allow), \
        jconfig.AnalysisConfig(allow=allow)
    for loc in ("docs/notes.md", "exact.py", "src/exact.py", "src/a/b.py",
                "other.py", "docs\\win.md"):
        for rule in ("r", "q"):
            assert port.allowed(rule, loc) == ref.allowed(rule, loc)
    for line in (0, 3):
        f = Finding(rule="r", location="a.py", line=line, message="m")
        j = JFinding(rule="r", location="a.py", line=line, message="m")
        assert f.render() == j.render() and f.as_dict() == j.as_dict()
        assert json.loads(json.dumps(f.as_dict())) == j.as_dict()


def test_config_loads_the_package_file_and_a_given_one(tmp_path):
    default = tconfig.AnalysisConfig.load()
    assert default.allowed("wall-clock", "src/repro_torch/serving/lm.py")
    assert not default.allowed("wall-clock",
                               "src/repro_torch/serving/batcher.py")
    other = tmp_path / "other.toml"
    other.write_text('[rules.wall-clock]\nallow = ["x.py"]\nprefix = "s/"\n')
    cfg = tconfig.AnalysisConfig.load(other)
    assert cfg.allow == {"wall-clock": ["x.py"]}
    assert cfg.options == {"wall-clock": {"prefix": "s/"}}
    assert tconfig.AnalysisConfig.load(tmp_path / "none.toml") \
        == tconfig.AnalysisConfig()


# ---------------------------------------------------------------------------
# The port's own pass over the repo.
# ---------------------------------------------------------------------------

def test_port_lint_pass_is_clean():
    findings = run_lint(REPO, ALL_RULES)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_wall_clock_allowlist_holds_exactly_the_seam_owners():
    cfg = tconfig.AnalysisConfig.load()
    del cfg.allow["wall-clock"]
    findings = run_lint(REPO, ALL_RULES, cfg)
    assert {f.rule for f in findings} == {"wall-clock"}
    by_file = {}
    for f in findings:
        by_file[f.location] = by_file.get(f.location, 0) + 1
    assert by_file == {"src/repro_torch/serving/core.py": 9,
                       "src/repro_torch/serving/lm.py": 6,
                       "src/repro_torch/serving/trigger.py": 2}


def test_cli_lint_only_runs_clean(capsys):
    rc = main(["--lint-only", "--json", "--root", str(REPO)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["count"] == 0 and doc["findings"] == []
    assert set(doc["timings"]) == {"lint_s"}
    assert doc["rules"] == [r.name for r in ALL_RULES]


def test_cli_reports_findings_with_a_given_config(tmp_path, capsys):
    empty = tmp_path / "empty.toml"
    empty.write_text("")
    rc = main(["--lint-only", "--rules", "wall-clock", "--config", str(empty),
               "--root", str(REPO)])
    out = capsys.readouterr()
    assert rc == 1 and out.out.count("[wall-clock]") == 17
    assert "17 finding(s)" in out.err


# ---------------------------------------------------------------------------
# Each rule bites.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule,files,want", [
    (ThinCliRule(), {"src/repro_torch/launch/serve.py": (
        "import torch\n"
        "from repro_torch.core import paths\n"
        "def helper():\n"
        "    return 1\n"
        "def main():\n"
        "    for _ in range(2):\n"
        "        pass\n"), "src/repro_torch/launch/trigger_serve.py": (
        "from repro_torch.serving.trigger import run\n"
        "def main():\n"
        "    return run()\n"
        "if __name__ == '__main__':\n"
        "    main()\n")},
     [("src/repro_torch/launch/serve.py", n) for n in (0, 1, 2, 3, 6)]),
    (KernelContainmentRule(), {
        "src/repro_torch/serving/fast.py": (
            "import ctypes\n"
            "import triton\n"
            "lib = ctypes.CDLL('libk.so')\n"
            "@triton.jit\n"
            "def k(x):\n"
            "    pass\n"),
        "src/repro_torch/serving/stray.cu": "__global__ void k() {}\n",
        "src/repro_torch/kernels/csrc/ok.cu": "__global__ void k() {}\n",
        "src/repro_torch/kernels/ok.py": (
            "import ctypes\nlib = ctypes.CDLL('libk.so')\n"),
        "chip.py": ("from repro_torch.kernels import build\n"
                    "build.build_library('k', ('k.cu',))\n")},
     [("src/repro_torch/serving/fast.py", 3),
      ("src/repro_torch/serving/fast.py", 4),
      ("src/repro_torch/serving/stray.cu", 0)]),
    (WallClockRule(), {"src/repro_torch/serving/new.py": (
        "import time\n"
        "def f(clock=time.monotonic):\n"
        "    return time.perf_counter() - clock()\n")},
     [("src/repro_torch/serving/new.py", 3)]),
    (RegisterPathDeclRule(), {"src/repro_torch/core/new.py": (
        "from repro_torch.core.paths import register_path\n"
        "@register_path(name='x', fused_level='none', complexity='O(N)')\n"
        "def forward_x(p, cfg, x):\n"
        "    return x\n")},
     [("src/repro_torch/core/new.py", 2)]),
], ids=["fat-cli", "ctypes-in-serving", "perf_counter", "no-fallback"])
def test_each_port_rule_bites(tmp_path, rule, files, want):
    _tree(tmp_path, files)
    findings = run_lint(tmp_path, [rule], tconfig.AnalysisConfig())
    assert sorted(_pairs(findings)) == sorted(want)
    assert {f.rule for f in findings} == {rule.name}
