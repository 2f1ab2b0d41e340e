"""The port's LM serving on ``device="cpu"``: engine, ladder, CLI.

At ``tiny_config("h2o-danube-1.8b")`` (2 layers, d_model 128, fp32) with
the reference's weights carried across by ``bridge.params_from_jax``,
the port's :class:`LMEngine` gives exactly the reference's greedy token
streams (the decode step's attention runs kernel B5's plain version
here).  The scheduling tests follow ``tests/test_loop.py``'s LM cases;
the CLI prints the reference's ``[serve]`` report and refuses ``cuda``
where there is no card; ``launch/serve.py`` stays as thin as the
reference's guard keeps the reference's.
"""

import ast
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from repro.analysis.config import AnalysisConfig
from repro.analysis.lint import run_lint
from repro.analysis.rules.thin_cli import ThinCliRule
from repro.configs.registry import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.models import transformer as jtfm
from repro.serving import lm as jlm
from repro_torch import bridge
from repro_torch.analysis.config import AnalysisConfig as PortAnalysisConfig
from repro_torch.analysis.rules.thin_cli import ThinCliRule as PortThinCliRule
from repro_torch.configs.registry import get_arch
from repro_torch.examples import serve_lm
from repro_torch.launch import serve
from repro_torch.serving import FaultInjector, InjectedFault, LMEngine
from repro_torch.serving.lm import prompt_bucket_ladder, tiny_config

REPO = pathlib.Path(__file__).resolve().parent.parent


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _setup(arch_id):
    jcfg = jlm.tiny_config(jget_arch(arch_id).model)
    cfg = tiny_config(get_arch(arch_id).model)
    jp = jax.tree_util.tree_map(np.asarray,
                                jtfm.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, jp, bridge.params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def lm_setup():
    return _setup("h2o-danube-1.8b")


def _engine(lm_setup, **kw):
    _, cfg, _, params = lm_setup
    return LMEngine(params, cfg, device="cpu", **kw)


def test_tiny_config_and_ladder_match_the_reference():
    for arch_id in ("h2o-danube-1.8b", "minicpm-2b", "phi3-medium-14b"):
        assert tiny_config(get_arch(arch_id).model).__dict__ \
            == jlm.tiny_config(jget_arch(arch_id).model).__dict__
    for n in (1, 15, 16, 17, 64, 100, 4096):
        assert prompt_bucket_ladder(n) == jlm.prompt_bucket_ladder(n)
    with pytest.raises(ValueError, match="max_len"):
        prompt_bucket_ladder(0)


@pytest.mark.parametrize("arch_id", ["h2o-danube-1.8b", "minicpm-2b",
                                     "moonshot-v1-16b-a3b"])
def test_lm_engine_reproduces_the_reference_token_streams(arch_id):
    """The prompts of the reference's pinning test (slots 3, max_seq 64,
    max_new 5): the port's greedy streams equal the JAX LMEngine's, for
    danube's sliding window, minicpm's tied head and moonshot's MoE
    (64 experts, top-6: the 16-token prefill rung, pad tokens included,
    and each 3-slot decode step route at a capacity of 8)."""
    jcfg, cfg, jp, tp = _setup(arch_id)
    slots, max_seq, max_new = 3, 64, 5
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, pl)
               for pl in (7, 13, 9, 16, 5)]
    jeng = jlm.LMEngine(jax.tree_util.tree_map(jax.numpy.asarray, jp), jcfg,
                        slots=slots, max_seq=max_seq)
    teng = LMEngine(tp, cfg, slots=slots, max_seq=max_seq, device="cpu")
    for p in prompts:
        jeng.submit(p, max_new)
        teng.submit(p, max_new)
    want = {r.rid: r.out for r in jeng.run()["done"]}
    report = teng.run()
    got = {r.rid: r.out for r in report["done"]}
    assert got == want                      # EXACT greedy token streams
    assert report["steps"] == jeng.metrics.counter("decode_steps")
    assert teng.metrics.counter("tokens_emitted") == 5 * max_new


def test_lm_report_times_each_decode_step_apart(lm_setup):
    """``run()`` reports this drain's decode-step seconds apart from the
    prefills that share the metrics' batch records."""
    eng = _engine(lm_setup, slots=2, max_seq=64)
    for pl in (3, 20, 9):
        eng.submit(np.arange(pl) % 512, 3)
    report = eng.run()
    assert len(report["decode_step_s"]) == report["steps"]
    assert eng.metrics.batches == report["steps"] + 3     # + 3 prefills
    assert all(s > 0 for s in report["decode_step_s"])
    eng.submit(np.arange(5) % 512, 2)
    again = eng.run()
    assert len(again["decode_step_s"]) == again["steps"] - report["steps"]


def test_lm_callables_scope_the_rounding_flags(lm_setup, monkeypatch):
    """The cuBLAS rounding flags are process-wide: the model functions
    leave them alone, and the engine's callables set them for their own
    call only and restore them after."""
    from repro_torch.models import transformer as tfm
    mm = torch.backends.cuda.matmul
    monkeypatch.setattr(mm, "allow_bf16_reduced_precision_reduction", True)
    monkeypatch.setattr(mm, "allow_tf32", True)
    seen = []
    forward = tfm.forward

    def spy(*args, **kw):
        seen.append((mm.allow_bf16_reduced_precision_reduction,
                     mm.allow_tf32))
        return forward(*args, **kw)
    _, cfg, _, params = lm_setup
    tfm.forward(params, cfg, torch.zeros((1, 4), dtype=torch.int32))
    assert mm.allow_bf16_reduced_precision_reduction and mm.allow_tf32
    monkeypatch.setattr(tfm, "forward", spy)
    eng = _engine(lm_setup, slots=1, max_seq=16)
    eng.submit(np.arange(4), 2)
    eng.run()
    assert seen == [(False, False)]
    assert mm.allow_bf16_reduced_precision_reduction and mm.allow_tf32


def test_lm_single_prefill_build_across_mixed_lengths(lm_setup):
    eng = _engine(lm_setup, slots=2, max_seq=64)
    assert eng.bucket_sizes == [16, 32, 64]
    for pl in (3, 7, 11, 16):           # all pad to the 16 rung
        eng.submit(np.arange(pl) % 512, 2)
    report = eng.run()
    assert report["prefill_compiles"] == 1
    assert eng.metrics.counter("prefills") == 4
    # a longer prompt earns exactly one more rung
    eng.submit(np.arange(20) % 512, 2)
    eng.run()
    assert sum(1 for k in eng._cache if k[1] != "decode") == 2


def test_lm_deadline_sheds_queued_requests(lm_setup):
    clk = FakeClock()
    eng = _engine(lm_setup, slots=1, max_seq=32, clock=clk)
    a = eng.submit(np.arange(4), 3)                       # no deadline
    b = eng.submit(np.arange(5), 3, deadline_s=0.5)       # queued behind a
    clk.t += 10.0                       # b expires while a holds the slot
    report = eng.run()
    assert not a.shed and len(a.out) == 3
    assert b.shed and b.out == []
    assert report["shed"] == 1
    assert eng.health()["state"] == "shedding"
    assert eng.metrics.counter("lm_shed_requests") == 1


@pytest.mark.parametrize("seam", ["compile", "dispatch"])
def test_lm_fault_seams_fire_on_the_decode_bucket(lm_setup, seam):
    """A fault armed on ``path="lm"``, bucket ``"decode"`` fires once at
    its seam; the spent fault lets the same engine drain afterwards."""
    inj = FaultInjector()
    inj.arm(seam, path="lm", bucket="decode", times=1)
    eng = _engine(lm_setup, slots=1, max_seq=32, injector=inj)
    req = eng.submit(np.arange(5), 3)
    with pytest.raises(InjectedFault, match=seam):
        eng.run()
    assert inj.fired(seam) == 1 and req.out and len(req.out) == 1
    report = eng.run()
    assert report["done"] == [req] and len(req.out) == 3


@pytest.mark.parametrize("prompt", [np.arange(17), np.zeros(0)],
                         ids=["oversized", "empty"])
def test_lm_rejects_a_prompt_it_cannot_hold(lm_setup, prompt):
    eng = _engine(lm_setup, slots=1, max_seq=16)
    with pytest.raises(ValueError, match="exceeds max_seq|empty prompt"):
        eng.submit(prompt, 1)


def test_warm_leaves_the_live_cache_untouched(lm_setup):
    """warm() builds every prefill rung and runs the decode step against a
    throwaway cache: the live cache, written in place by decode steps,
    stays bitwise as it was."""
    eng = _engine(lm_setup, slots=2, max_seq=32)
    eng.submit(np.arange(9), 4)
    eng.submit(np.arange(3, 20), 4)
    eng.step()
    eng.step()
    before = {k: v.clone() for k, v in eng.cache.items()}
    eng.warm()
    assert all(torch.equal(before[k], eng.cache[k]) for k in before)
    assert eng.cache_size == len(eng.bucket_sizes) + 1
    report = eng.run()
    assert [len(r.out) for r in report["done"]] == [4, 4]


def test_admit_splices_the_prompt_into_its_slot(lm_setup):
    """_admit writes the prompt's rows into the slot and zeroes the rest;
    slot_pos marks the rest empty (-1)."""
    eng = _engine(lm_setup, slots=2, max_seq=32)
    eng.submit(np.arange(5), 2)
    eng.step()                           # admit into slot 0 + one decode
    assert eng.cache["pos"].tolist() == [6, 1]
    sp = eng.cache["slot_pos"][0].tolist()
    assert sp[:6] == list(range(6)) and set(sp[6:]) == {-1}
    assert not eng.cache["k"][:, 0, 6:].any()
    assert eng.cache["k"][:, 0, :6].abs().sum(-1).all()


def _report_lines(out: str) -> list:
    """The [serve] report with its rate (a wall-clock number) and the
    token values (from another generator) blanked."""
    lines = [ln for ln in out.splitlines() if ln.startswith(("[serve]",
                                                               "  req "))]
    return [re.sub(r"\[[\d, ]+\]\.\.\.$", "[...]...",
                   re.sub(r"[\d.]+ steps/s", "R steps/s", ln))
            for ln in lines]


def test_cli_prints_the_reference_serve_report(capsys):
    argv = ["--tiny", "--requests", "6", "--slots", "3", "--prompt-len",
            "20", "--max-new", "4", "--max-seq", "32", "--health"]
    jserve.main(argv)
    want = capsys.readouterr().out
    report = serve.main(argv + ["--device", "cpu", "--seed", "3"])
    got = capsys.readouterr().out
    assert _report_lines(got) == _report_lines(want)
    assert "[health] state=healthy free_slots=3 queue_depth=0" in got
    assert report["prefill_compiles"] == 1 and report["shed"] == 0
    assert all(len(r.out) == 4 for r in report["done"])


def test_cli_serves_the_moe_lm_as_the_reference_does(capsys):
    """``--arch moonshot-v1-16b-a3b --tiny --device cpu`` serves through
    ``LMEngine`` and prints the reference CLI's report."""
    argv = ["--arch", "moonshot-v1-16b-a3b", "--tiny", "--requests", "4",
            "--slots", "2", "--prompt-len", "20", "--max-new", "3",
            "--max-seq", "32"]
    jserve.main(argv)
    want = capsys.readouterr().out
    report = serve.main(argv + ["--device", "cpu"])
    assert _report_lines(capsys.readouterr().out) == _report_lines(want)
    assert len(report["done"]) == 4 and report["shed"] == 0


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--tiny", "--requests", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        LMEngine(None, tiny_config(get_arch("h2o-danube-1.8b").model))


def test_cli_refuses_a_non_lm_arch():
    with pytest.raises(ValueError, match="LM archs"):
        serve.main(["--arch", "fm", "--device", "cpu"])


def test_example_serves_on_the_cpu(capsys):
    report = serve_lm.main(["--device", "cpu"])
    assert "[serve] 8 requests" in capsys.readouterr().out
    assert report["prefill_compiles"] == 1


def test_serve_cli_stays_thin():
    """The reference's thin-CLI rule over the port's shell, the port's
    own rule over both of its shells, and the shell's one framework
    import is the port's serving package."""
    rel = "src/repro_torch/launch/serve.py"
    config = AnalysisConfig()
    config.options["thin-cli"] = {"paths": [rel]}
    findings = run_lint(REPO, [ThinCliRule()], config)
    assert findings == [], "\n".join(f.render() for f in findings)
    # the port's own rule, at its default scope (both of the port's CLIs)
    port = run_lint(REPO, [PortThinCliRule()], PortAnalysisConfig())
    assert port == [], "\n".join(f.render() for f in port)
    tree = ast.parse((REPO / rel).read_text())
    mods = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    mods += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    assert [m for m in mods if m.startswith("repro_torch")] \
        == ["repro_torch.serving.lm"]
