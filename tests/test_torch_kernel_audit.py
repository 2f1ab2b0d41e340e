"""The port's kernel-contract auditor (``repro_torch.analysis.kernel_audit``).

Its CPU half on the real registry at jedi_30p, jedi_50p and
jedi_tracks_128 (clean, every kernel path audited at every rung), each
CPU detector on a broken fixture, and its readers of the build (ptxas
report, resource usage, SASS) on text recorded on one H100: the
card half itself runs on the card (``chip_smoke.py`` phase 13).

The recorded excerpts come from ``kernels/build.py``'s ``-Xptxas -v``
report and ``cuobjdump`` of the libraries built from this tree's
sources on an NVIDIA H100 80GB HBM3 (700.00 W), CUDA 12.9, pasted
unchanged.
"""

import dataclasses
import json
import re
import shutil

import pytest
import torch

from repro_torch.analysis import kernel_audit as KA
from repro_torch.analysis.__main__ import main
from repro_torch.configs import jedi_30p, jedi_50p, jedi_tracks_128
from repro_torch.core import interaction_net as inet
from repro_torch.core import paths
from repro_torch.core.int8_path import dequantize_params, quantize_params_int8
from repro_torch.kernels.fused_jedinet import autotune as fj
from repro_torch.kernels.fused_jedinet import full_kernel as FK

CONFIGS = {"jedi_30p": jedi_30p.MODEL, "jedi_50p": jedi_50p.MODEL,
           "jedi_tracks_128": jedi_tracks_128.MODEL}


@pytest.fixture(scope="module")
def params():
    return {arch: inet.init(0, cfg, device="cpu")
            for arch, cfg in CONFIGS.items()}


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# The real registry, on the CPU.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(CONFIGS))
def test_registry_audits_clean_at_every_rung(arch, params):
    cfg = CONFIGS[arch]
    plans = []
    findings = KA.audit_registry(cfg, params[arch], max_batch=1024,
                                 plans=plans)
    assert findings == [], "\n".join(f.render() for f in findings)
    kernel_paths = paths.specs(cuda=True)
    assert len(kernel_paths) == 5
    for spec in kernel_paths:
        ladder = spec.bucket_ladder(cfg, spec.prepare_params(params[arch]),
                                    1024)
        audited = [p.location for p in plans
                   if p.location.split()[0] == f"path={spec.name}"]
        assert audited == [f"path={spec.name} bucket={b}" for b in ladder]
    assert KA.audit_sources() == []


def test_cli_audit_on_the_cpu_is_clean(capsys):
    rc = main(["--audit-only", "--device", "cpu", "--json", "--arch",
               "jedi_30p,jedi_50p,jedi_tracks_128"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["count"] == 0 and doc["findings"] == []
    assert set(doc["timings"]) == {"audit_s"}
    audit = doc["audit"]
    assert audit["device"] == "cpu" and "not run" in audit["card_checks"]
    assert set(audit["audited"]) == set(CONFIGS)
    assert all(a["paths"] == 9 and a["kernel_paths"] == 5
               for a in audit["audited"].values())


def test_cli_audit_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--audit-only", "--arch", "jedi_30p"])


# ---------------------------------------------------------------------------
# B1's bucket model is the launch B1 runs.
# ---------------------------------------------------------------------------

def _team_hooks(name):
    """The spec as the parent tree registered it: no bucket hooks, so
    ``PathSpec`` falls back to B1's team layout."""
    return dataclasses.replace(paths.get(name), per_sample_bytes=None,
                               reserved_bytes=None)


@pytest.mark.parametrize("name", ["fused_full", "int8_fused_full"])
def test_fused_full_ladder_comes_from_b1s_launch(name, params):
    spec = paths.get(name)
    doublings = [8, 16, 32, 64, 128, 256, 512, 1024]
    want = {"jedi_30p": doublings, "jedi_50p": doublings,
            "jedi_tracks_128": [1, 2, 4] + doublings}
    for arch, cfg in CONFIGS.items():
        p = spec.prepare_params(params[arch])
        lay = fj.full_layout_for(cfg, p)
        assert spec.bucket_bytes(cfg, p) == lay.batch_bytes
        assert spec.reserved_smem_bytes(cfg, p) == lay.reserved_bytes
        assert spec.bucket_ladder(cfg, p, 1024) == want[arch], arch
        # the team layout's model: unchanged where B1 launches it, and
        # at jedi_50p a rung 4 from a layout B1 never runs there
        old = _team_hooks(name).bucket_ladder(cfg, p, 1024)
        assert old == ([4] + doublings if arch == "jedi_50p"
                       else want[arch]), arch


def test_auditor_reports_the_team_layout_model_at_jedi_30p(params):
    cfg = CONFIGS["jedi_30p"]
    findings = KA.audit_path(_team_hooks("fused_full"), cfg,
                             params["jedi_30p"], max_batch=64)
    assert _rules(findings) == {"audit-tile-mismatch"}
    assert [f.location for f in findings] == [
        f"path=fused_full bucket={b}" for b in (8, 16, 32, 64)]
    assert "15936 B an event and 90736 B reserved" in findings[0].message
    assert "warp plan" in findings[0].message
    assert "0 B and 24304 B" in findings[0].message


# ---------------------------------------------------------------------------
# Each CPU detector bites.
# ---------------------------------------------------------------------------

def test_auditor_detects_bytes_model_2x_disagreement(params):
    cfg = CONFIGS["jedi_tracks_128"]
    tp = params["jedi_tracks_128"]
    per_event = fj.full_layout_for(cfg, tp).per_event_bytes
    spec = dataclasses.replace(
        paths.get("fused_full"), name="bad_2x",
        per_sample_bytes=lambda c, p: 2 * per_event)
    findings = KA.audit_path(spec, cfg, tp, max_batch=16)
    assert _rules(findings) == {"audit-tile-mismatch"}
    assert f"{2 * per_event} B an event" in findings[0].message
    assert f"team plan the wrapper launches {per_event} B" \
        in findings[0].message


def test_auditor_detects_ladder_rung_over_budget(params):
    cfg = CONFIGS["jedi_30p"]
    findings = KA.audit_path(paths.get("fused_full"), cfg,
                             params["jedi_30p"], max_batch=16,
                             budget_bytes=30000)
    assert _rules(findings) == {"audit-ladder-budget"}
    assert [f.location for f in findings] == [
        "path=fused_full bucket=8", "path=fused_full bucket=16"]
    assert "43040 B of shared memory over the 30000 B" in findings[0].message


def test_auditor_detects_partially_quantized_tree(params):
    def half_quantize(p):
        q = quantize_params_int8(p)
        return {"fr": q["fr"], "fo": p["fo"], "phi": p["phi"]}

    spec = dataclasses.replace(paths.get("int8_fused_full"),
                               name="int8_partial",
                               transform_params=half_quantize)
    findings = KA.audit_path(spec, CONFIGS["jedi_30p"], params["jedi_30p"],
                             max_batch=64)
    assert [f.rule for f in findings] == ["audit-int8-operands"]
    assert "partially quantized" in findings[0].message


def test_auditor_detects_weights_dequantized_on_the_host(params):
    """A quantized path whose transform hands the kernel fp32 weights:
    no integer buffer, no scales."""
    spec = dataclasses.replace(
        paths.get("int8_fused_full"), name="int8_host_dequant",
        transform_params=lambda p: dequantize_params(quantize_params_int8(p)))
    findings = KA.audit_path(spec, CONFIGS["jedi_30p"], params["jedi_30p"],
                             max_batch=64)
    assert _rules(findings) == {"audit-int8-operands"}
    text = "\n".join(f.message for f in findings)
    assert "ships torch.float32 weights" in text and "no scales" in text


def test_auditor_flags_kernel_path_without_a_plan(params):
    spec = dataclasses.replace(paths.get("fused_full"), name="no_plan",
                               forward=inet.forward_sr)
    findings = KA.audit_path(spec, CONFIGS["jedi_30p"], params["jedi_30p"],
                             max_batch=64)
    assert [f.rule for f in findings] == ["audit-no-plan"]


def test_auditor_detects_bf16_logits(monkeypatch, params):
    """B1's wrapper handing back bf16 logits: the path's forward, called
    as serving calls it, returns them."""
    call = FK.fused_forward_full_kernel_call

    def bf16_logits(*a, **kw):
        return call(*a, **kw).to(torch.bfloat16)

    bf16_logits.launches = 0
    monkeypatch.setattr(FK, "fused_forward_full_kernel_call", bf16_logits)
    findings = KA.audit_path(paths.get("fused_full"), CONFIGS["jedi_30p"],
                             params["jedi_30p"], max_batch=16)
    assert [f.rule for f in findings] == ["audit-accum-dtype"]
    assert "torch.bfloat16" in findings[0].message \
        and "float32" in findings[0].message


@pytest.mark.parametrize("name,old,new,fragment", [
    ("flash_decode.cu", "kMaxSmem = 227 * 1024", "kMaxSmem = 228 * 1024",
     "kMaxSmem is 233472 in the source"),
    ("fm_interaction.cu", "kMaxSmem = 48 * 1024", "kMaxSmem = 64 * 1024",
     "kMaxSmem is 65536 in the source"),
    ("flash_decode.cu", "kStages = 3;", "kStages = 4;", "kStages is 4"),
    ("jedi_warp.cuh", "kEdgeRegs = 8;", "kEdgeRegs = 16;", "kEdgeRegs is 16"),
    ("jedi_warp.cuh", "RW <= 32 ? 2 : 1", "RW <= 20 ? 2 : 1", "warp_rpl"),
    ("jedi_common.cuh", "F(epb) F(bs)", "F(bs) F(epb)", "launch header"),
], ids=["b5-kMaxSmem", "b4-kMaxSmem", "kStages", "kEdgeRegs", "warp_rpl",
        "header"])
def test_auditor_detects_source_mirror_drift(tmp_path, name, old, new,
                                             fragment):
    csrc = tmp_path / "csrc"
    shutil.copytree(KA.CSRC, csrc)
    text = (csrc / name).read_text()
    assert old in text
    (csrc / name).write_text(text.replace(old, new))
    findings = KA.audit_sources(csrc)
    assert [f.rule for f in findings] == ["audit-source-mirror"]
    assert findings[0].location == str(csrc / name)
    assert fragment in findings[0].message
    # the line the constant, the function or the header block starts on
    anchor = re.match(r"\w+|F", new).group(0)
    anchor = {"RW": "warp_rpl", "F": "HEADER-FIELDS-BEGIN"}.get(anchor, anchor)
    line = text.replace(old, new).splitlines()[findings[0].line - 1]
    assert findings[0].line > 0 and anchor in line


# ---------------------------------------------------------------------------
# The card half's readers, on text recorded on one H100.
# ---------------------------------------------------------------------------

#: fused_jedinet_full's ptxas report: B1's warp<20,0> and warp<20,1>
#: kernels and the device function between them, as recorded.
PTXAS_EXCERPT = """\
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__0737ce60_21_fused_jedinet_full_cu_dcff5cd027jedi_fused_full_warp_kernelILi20ELb0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__0737ce60_21_fused_jedinet_full_cu_dcff5cd027jedi_fused_full_warp_kernelILi20ELb0EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 121 registers, used 16 barriers
ptxas info    : Compile time = 750.952 ms
ptxas info    : Function properties for _ZN52_INTERNAL_0737ce60_21_fused_jedinet_full_cu_dcff5cd054_GLOBAL__N__0737ce60_21_fused_jedinet_full_cu_dcff5cd013activate_callEfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__0737ce60_21_fused_jedinet_full_cu_dcff5cd027jedi_fused_full_warp_kernelILi20ELb1EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__0737ce60_21_fused_jedinet_full_cu_dcff5cd027jedi_fused_full_warp_kernelILi20ELb1EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers
ptxas info    : Compile time = 765.767 ms
"""

#: fm_interaction's ``cuobjdump --dump-resource-usage``, as recorded.
RESOURCE_EXCERPT = """\
Resource usage:
 Common:
  GLOBAL:0
 Function _ZN50_GLOBAL__N__03467811_17_fm_interaction_cu_b885331f21fm_interaction_kernelIfEEvPKT_Pfiiii:
  REG:32 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:560 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN50_GLOBAL__N__03467811_17_fm_interaction_cu_b885331f21fm_interaction_kernelI13__nv_bfloat16EEvPKT_Pfiiii:
  REG:40 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:560 TEXTURE:0 SURFACE:0 SAMPLER:0
"""

#: flash_decode's SASS (``cuobjdump -sass``): the tensor-core kernel's
#: header and its first three HMMA instructions, as recorded.
SASS_EXCERPT = (
    "\t\tFunction : _ZN48_GLOBAL__N__bafb2253_15_flash_decode_cu_852776ca2"
    "3flash_decode_mma_kernelILi8EEEvNS_4ArgsE\n"
    "        /*8780*/                   HMMA.16816.F32.BF16 R52, R52, R10, "
    "RZ ;                    /* 0x0000000a3434723c */\n"
    "                                                                     "
    "                         /* 0x002fde00000418ff */\n"
    "        /*87a0*/                   HMMA.16816.F32.BF16 R52, R48, R12, "
    "R52 ;                   /* 0x0000000c3034723c */\n"
    "                                                                     "
    "                         /* 0x004fe20000041834 */\n"
    "        /*87d0*/                   HMMA.16816.F32.BF16 R52, R40, R14, "
    "R52 ;                   /* 0x0000000e2834723c */\n")

WARP20 = "jedi_fused_full_warp_kernel<20,0>"


@pytest.mark.parametrize("mangled,short", [
    ("_ZN54_GLOBAL__N__0737ce60_21_fused_jedinet_full_cu_dcff5cd027jedi_"
     "fused_full_warp_kernelILi64ELb1EEEvNS_4ArgsE",
     "jedi_fused_full_warp_kernel<64,1>"),
    ("_ZN54_GLOBAL__N__0737ce60_21_fused_jedinet_full_cu_dcff5cd027jedi_"
     "fused_full_tile_kernelILi12EEEvNS_4ArgsE",
     "jedi_fused_full_tile_kernel<12>"),
    ("_ZN54_GLOBAL__N__0737ce60_21_fused_jedinet_full_cu_dcff5cd022jedi_"
     "fused_full_kernelENS_4ArgsE", "jedi_fused_full_kernel"),
    ("_ZN52_GLOBAL__N__883adb09_19_jedi_linear_full_cu_274957c123jedi_"
     "linear_rows_kernelILi6EEEvNS_4ArgsE", "jedi_linear_rows_kernel<6>"),
    ("_ZN48_GLOBAL__N__bafb2253_15_flash_decode_cu_852776ca19flash_decode_"
     "kernelI13__nv_bfloat16Li1EEEvNS_4ArgsE", "flash_decode_kernel<bf16,1>"),
    ("_ZN48_GLOBAL__N__bafb2253_15_flash_decode_cu_852776ca19flash_decode_"
     "kernelIfLi8EEEvNS_4ArgsE", "flash_decode_kernel<f32,8>"),
    ("_ZN48_GLOBAL__N__bafb2253_15_flash_decode_cu_852776ca20flash_decode_"
     "combineEPKfPfiii", "flash_decode_combine"),
    ("_ZN52_INTERNAL_0737ce60_21_fused_jedinet_full_cu_dcff5cd054_GLOBAL__N_"
     "_0737ce60_21_fused_jedinet_full_cu_dcff5cd013activate_callEfi",
     "activate_call"),
])
def test_kernel_name_shortens_recorded_names(mangled, short):
    assert KA.kernel_name(mangled) == short


def test_ptxas_excerpt_parses_clean():
    ptxas = KA.parse_ptxas(PTXAS_EXCERPT)
    assert ptxas == {
        WARP20: KA.PtxasEntry(registers=121),
        "activate_call": KA.PtxasEntry(),
        "jedi_fused_full_warp_kernel<20,1>": KA.PtxasEntry(registers=128)}
    assert KA.check_spills(ptxas, required=(WARP20,)) == []
    # B1 at jedi_30p: 16 warps of 121 registers, 3,872 each rounded up to
    # 4,096, take exactly the SM's 65,536
    built = {"fused_jedinet_full": {"ptxas": ptxas}}
    plan = KA.LaunchPlan("path=fused_full bucket=8", "fused_jedinet_full",
                         WARP20, 512, 43040)
    stats = {}
    assert KA.check_plans(built, [plan], stats) == []
    assert stats["tightest_registers"]["allocated"] == 65536
    assert stats["tightest_registers"]["share"] == 1.0


def test_registers_past_the_file_are_a_finding():
    built = {"fused_jedinet_full": {"ptxas": KA.parse_ptxas(PTXAS_EXCERPT)}}
    plan = KA.LaunchPlan("path=fused_full bucket=8", "fused_jedinet_full",
                         WARP20, 544, 43040)
    findings = KA.check_plans(built, [plan])
    assert [f.rule for f in findings] == ["audit-registers"]
    assert "121 registers x 544 threads take 69632" in findings[0].message
    missing = dataclasses.replace(plan, function="jedi_fused_full_kernel")
    assert [f.rule for f in KA.check_plans(built, [missing])] \
        == ["audit-registers"]


def test_spill_in_the_excerpt_is_a_finding():
    spilled = PTXAS_EXCERPT.replace(
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 121",
        "8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 121")
    ptxas = KA.parse_ptxas(spilled)
    assert ptxas[WARP20].spill_bytes == 12
    findings = KA.check_spills(ptxas, required=(WARP20,))
    assert [f.rule for f in findings] == ["audit-spills"]
    assert "spills 12 B" in findings[0].message
    assert [f.rule for f in KA.check_spills(ptxas, required=(
        "jedi_edge_block_warp_kernel<20,0>",))] == ["audit-spills"]


def test_resource_usage_and_shared_memory():
    res = KA.parse_resource_usage(RESOURCE_EXCERPT)
    assert res["fm_interaction_kernel<f32>"]["SHARED"] == 1024
    assert res["fm_interaction_kernel<bf16>"]["REG"] == 40
    built = {"fm_interaction": {
        "ptxas": {"fm_interaction_kernel<f32>": KA.PtxasEntry(32)},
        "resources": res}}

    def plan(smem):
        return KA.LaunchPlan("kernel=fm_interaction shape=x",
                             "fm_interaction", "fm_interaction_kernel<f32>",
                             256, smem)

    assert KA.check_plans(built, [plan(KA.SMEM_OPT_IN)]) == []
    findings = KA.check_plans(built, [plan(KA.SMEM_OPT_IN + 1)])
    assert [f.rule for f in findings] == ["audit-smem"]


def test_sass_excerpt_accumulates_in_f32():
    sass = KA.parse_sass(SASS_EXCERPT)
    assert sass == {"flash_decode_mma_kernel<8>": ["HMMA.16816.F32.BF16"] * 3}
    assert KA.check_sass("flash_decode", sass) == []


def test_f16_accumulator_in_the_sass_is_a_finding():
    lines = SASS_EXCERPT.splitlines(keepends=True)
    lines[3] = lines[3].replace("HMMA.16816.F32.BF16", "HMMA.16816.F16")
    sass = KA.parse_sass("".join(lines))
    findings = KA.check_sass("flash_decode", sass)
    assert [f.rule for f in findings] == ["audit-accum-dtype"]
    assert findings[0].location == \
        "kernel=flash_decode function=flash_decode_mma_kernel<8>"
    assert re.search(r"HMMA\.16816\.F16 accumulates in F16", findings[0].message)


def test_lm_plans_name_built_functions():
    """B5's plans at the LM decode shapes and B4's at serve_bulk name the
    functions the recorded builds have (ptxas names of run 1)."""
    fns = {p.function for p in KA.lm_plans()}
    assert fns == {"flash_decode_mma_kernel<5>", "flash_decode_combine",
                   "flash_decode_kernel<bf16,1>", "fm_interaction_kernel<f32>",
                   "fm_interaction_kernel<bf16>"}
