"""Kernel-contract auditor of the port's hand-written CUDA kernels.

Port of ``repro.analysis.kernel_audit``, rebuilt for what a Hopper
kernel is.  The reference traced each Pallas path's forward to a jaxpr
and read the grid, the BlockSpecs and the dtypes the kernel asked the
compiler for.  The port's kernels are ``ctypes`` calls into libraries
that ``nvcc`` builds, so the same facts live in two places:

* on the CPU, the Python plans the wrappers launch (``Layout`` of
  ``kernels/fused_jedinet/autotune.py`` and
  ``kernels/jedi_linear/autotune.py``, B5's ``Plan``, B4's ``plan``),
  the packed ``KernelWeights`` and the constants the Python mirrors of
  the ``.cu`` / ``.cuh`` sources;
* on the card, the build: the ``-Xptxas -v`` report beside each library
  (registers, spills), ``cuobjdump``'s resource usage (static shared
  memory) and SASS (the tensor-core instructions and the type they
  accumulate in), and the wrappers' launch counters.

CPU checks, for every ``cuda=True`` path at every rung of its ladder
(:func:`audit_path`), and once per run (:func:`audit_sources`):

* ``audit-tile-mismatch`` — the path's bucket model
  (``PathSpec.bucket_bytes`` / ``reserved_smem_bytes``) is the
  ``batch_bytes`` / ``reserved_bytes`` of the plan its wrapper launches;
* ``audit-ladder-budget`` — that plan fits the opt-in shared memory
  and 1,024 threads in whole warps, a team layout's events fit its
  block, and the ladder is not empty;
* ``audit-int8-operands`` — a quantized path ships one integer weight
  buffer of ``weight_bytes`` an element, fp32 biases and one fp32 scale
  per weight tensor; a partly quantized tree is a finding;
* ``audit-accum-dtype`` — the forward on a bf16 ``x`` returns fp32
  logits (on the CPU: the plain version); a forward that raises is an
  ``audit-forward-failure``;
* ``audit-no-plan`` — a kernel path whose wrapper's plan the auditor
  cannot resolve (:func:`launchers`);
* ``audit-fallback-chain``, ``audit-source-mirror`` — the registry's
  chains, and each Python constant that mirrors a ``constexpr`` of a
  kernel source.

Checks on the card only (:func:`audit_build`, :func:`audit_path`'s
forward): ``audit-registers`` (every plan's threads x registers, in
sm_90's units of 256 a warp, within the 65,536 of an SM),
``audit-smem`` (static plus dynamic shared memory), ``audit-spills``
(none in the register-resident designs), ``audit-accum-dtype`` on the
SASS (every HMMA / HGMMA accumulates in F32; B5 has some) and
``audit-containment`` (a kernel path moves its kernel's launch count by
exactly one a forward, any other path none).

Findings use ``rule="audit-<check>"`` ids and ``path=<name>
bucket=<b>`` locations (``kernel=<library> ...`` for the build's), so
the ``analysis.toml`` allowlist machinery scopes them as it scopes lint.
"""

from __future__ import annotations

import ast
import concurrent.futures
import dataclasses
import pathlib
import re
import subprocess
import time
from typing import Callable

from repro_torch.analysis.findings import Finding
from repro_torch.kernels.autotune import MAX_THREADS_PER_BLOCK
from repro_torch.kernels.autotune import SMEM_BLOCK_BYTES as SMEM_OPT_IN
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.flash_decode.kernel import \
    SMEM_RESERVED_PER_BLOCK as SMEM_RESERVED

ROOT = CSRC.parents[3]

#: The register file of one SM, and the unit in which sm_90 gives a warp
#: its registers.
REGISTER_FILE = 65536
REGISTER_UNIT = 256
#: Threads of B5's combine kernel (``kCombineThreads``) and of B4's blocks
#: (``kThreads``), fixed in the sources.
COMBINE_THREADS = 256
FM_THREADS = 256

#: The register-resident designs phase 1 of ``chip_smoke.py`` requires
#: spill-free: B1's and B3's warp design at jedi_30p (RW 20, one sender
#: tile), B1's tile design and B3's warp design at jedi_50p (B3: RW 64, two
#: tiles), and every instance of B2's rows design (:data:`NO_SPILL_PREFIX`).
NO_SPILL = ("jedi_fused_full_warp_kernel<20,0>",
            "jedi_fused_full_tile_kernel<12>",
            "jedi_edge_block_warp_kernel<20,0>",
            "jedi_edge_block_warp_kernel<64,1>")
NO_SPILL_PREFIX = "jedi_linear_rows_kernel<"

#: B5 at the LM decode shapes the port serves, bf16 cache (PERF.md's
#: kernel table): h2o-danube-1.8b's decode step at 128 slots over 4,096,
#: moonshot-v1-16b-a3b's at 16 over 2,048 (MHA, G = 1), and danube's
#: decode_32k cell.
DECODE_SHAPES = {
    "danube_lm_decode": dict(b=128, s=4096, hkv=8, g=4, d=80),
    "moonshot_lm_decode": dict(b=16, s=2048, hkv=16, g=1, d=128),
    "danube_decode_32k": dict(b=128, s=32768, hkv=8, g=4, d=80),
}
#: B4 at the fm config's serve_bulk shape (F fields of K values).
FM_SHAPE = dict(f=39, k=10)


# ---------------------------------------------------------------------------
# Reading the build: ptxas reports, resource usage, SASS.
# ---------------------------------------------------------------------------

def kernel_name(mangled: str) -> str:
    """A mangled kernel name of a ptxas or cuobjdump report, short: the
    identifier and its template arguments
    (``jedi_fused_full_warp_kernel<20,0>``, ``flash_decode_kernel<bf16,1>``).
    The identifier follows the last ``_cu_<hash>`` of the file's
    anonymous namespace, so a device function of an internal namespace
    gets its own name too."""
    found = list(re.finditer(r"_cu_[0-9a-f]{8}(\d+)", mangled))
    if not found:
        return mangled
    m = found[-1]
    n = int(m.group(1))
    ident, rest = mangled[m.end():m.end() + n], mangled[m.end() + n:]
    if not rest.startswith("I"):
        return ident
    args = ["bf16" if "bfloat16" in rest else "f32"] \
        if rest.startswith(("If", "I13")) else []
    args += re.findall(r"L[ib](\d+)E", rest)
    return f"{ident}<{','.join(args)}>"


@dataclasses.dataclass
class PtxasEntry:
    """One function of a ``-Xptxas -v`` report: its registers a thread
    (None for a device function) and its spill stores plus loads.  Its
    static shared memory is read from ``cuobjdump``'s resource usage
    (:func:`parse_resource_usage`): ptxas of CUDA 12.9 prints none for
    these kernels."""

    registers: int | None = None
    spill_bytes: int = 0


def parse_ptxas(text: str) -> dict[str, PtxasEntry]:
    """``{function: PtxasEntry}`` of a library's ptxas report, keyed by
    :func:`kernel_name`."""
    out: dict[str, PtxasEntry] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = kernel_name(m.group(1))
            out.setdefault(cur, PtxasEntry())
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].spill_bytes = max(out[cur].spill_bytes,
                                       int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur].registers = int(m.group(1))
    return out


def parse_resource_usage(text: str) -> dict[str, dict[str, int]]:
    """``{function: {"REG": .., "SHARED": .., "LOCAL": .., ...}}`` of
    ``cuobjdump --dump-resource-usage``."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function (\S+):\s*$", line)
        if m:
            cur = kernel_name(m.group(1))
        elif cur is not None and "REG:" in line:
            out[cur] = {k: int(v) for k, v in
                        re.findall(r"([A-Z]+(?:\[\d+\])?):(\d+)", line)}
            cur = None
    return out


#: A tensor-core instruction of the SASS: ``HMMA.<shape>.<acc>[.<in>]``
#: (``mma.sync``) or ``HGMMA.<shape>.<acc>.<in>`` (``wgmma``).
MMA_OPCODE = re.compile(r"\b(?:HMMA|HGMMA)\.[\w.]+")


def parse_sass(text: str) -> dict[str, list[str]]:
    """``{function: [tensor-core opcodes]}`` of ``cuobjdump -sass``."""
    out: dict[str, list[str]] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernel_name(m.group(1))
            out.setdefault(cur, [])
        elif cur is not None:
            out[cur] += MMA_OPCODE.findall(line)
    return out


def accumulator(opcode: str) -> str:
    """The accumulator type of a tensor-core opcode (``F32`` of
    ``HMMA.16816.F32.BF16``)."""
    fields = opcode.split(".")
    return fields[2] if len(fields) > 2 else ""


def allocated_registers(registers: int, threads: int) -> int:
    """Registers a block of ``threads`` takes of its SM: each warp gets
    ``registers x 32`` rounded up to :data:`REGISTER_UNIT`."""
    per_warp = -(-registers * 32 // REGISTER_UNIT) * REGISTER_UNIT
    return per_warp * -(-threads // 32)


# ---------------------------------------------------------------------------
# The plans the wrappers launch.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Launcher:
    """How a kernel path's wrapper launches: its kernel (a key of
    :func:`kernels`), the plan it computes from the bound weights
    (``plan(cfg, weights)``, the wrapper's own call), the library
    function that plan runs (``function(layout, cfg)``, as named by
    :func:`kernel_name`) and the kernel weights inside the path's bound
    params."""

    kernel: str
    plan: Callable
    function: Callable
    weights: Callable


def launchers() -> dict[Callable, Launcher]:
    """The kernel paths' forward fns -> their :class:`Launcher`."""
    from repro_torch.core import int8_path
    from repro_torch.core import interaction_net as inet
    from repro_torch.core import jedi_linear_path as jlp
    from repro_torch.kernels.fused_jedinet import autotune as fj
    from repro_torch.kernels.fused_jedinet import full_kernel as FK
    from repro_torch.kernels.jedi_linear import autotune as jl

    def warp(name, team):
        # MULTI where a lane walks several sender tiles (N_o > 32)
        return lambda lay, cfg: (
            f"{name}<{lay.mw},{int(cfg.n_objects > 32)}>"
            if lay.design == "warp" else team)

    def b1_function(lay, cfg):
        if lay.design == "tile":       # M edges a thread
            return f"jedi_fused_full_tile_kernel<{lay.mw}>"
        return warp("jedi_fused_full_warp_kernel",
                    "jedi_fused_full_kernel")(lay, cfg)

    b1 = Launcher(
        "B1",
        lambda cfg, w: fj.plan_full(cfg.n_objects, w.n_features,
                                    *w.widths()),
        b1_function,
        lambda bound: bound)
    b2 = Launcher(
        "B2",
        lambda cfg, w: jl.plan_linear(cfg.n_objects, w.n_features,
                                      *w.widths()),
        lambda lay, cfg: (
            f"jedi_linear_rows_kernel<{FK.ACT_CODES[cfg.activation]}>"
            if lay.design == "rows" else "jedi_linear_full_kernel"),
        lambda bound: bound)
    b3 = Launcher(
        "B3",
        lambda cfg, w: fj.plan_edge(cfg.n_objects, w.n_features,
                                    w.widths()[0]),
        warp("jedi_edge_block_warp_kernel", "jedi_edge_block_kernel"),
        lambda bound: bound["fr"])
    return {inet.forward_fused_full: b1,
            int8_path.forward_int8_fused_full: b1,
            jlp.forward_jedi_linear_full: b2,
            jlp.forward_int8_jedi_linear_full: b2,
            inet.forward_fused: b3}


def kernels() -> dict[str, tuple]:
    """``{kernel: (library, sources, wrapper)}`` of B1-B5: what ``build``
    takes, and the wrapper whose ``launches`` count."""
    from repro_torch.kernels.flash_decode import kernel as FDK
    from repro_torch.kernels.fm_interaction import kernel as FMK
    from repro_torch.kernels.fused_jedinet import full_kernel as FK
    from repro_torch.kernels.fused_jedinet import kernel as EK
    from repro_torch.kernels.jedi_linear import linear_kernel as LK
    return {
        "B1": (FK.LIB_NAME, FK.SOURCES, FK.fused_forward_full_kernel_call),
        "B2": (LK.LIB_NAME, LK.SOURCES, LK.jedi_linear_kernel_call),
        "B3": (EK.LIB_NAME, EK.SOURCES, EK.fused_edge_block_kernel_call),
        "B4": (FMK.LIB_NAME, FMK.SOURCES, FMK.fm_interaction_kernel_call),
        "B5": (FDK.LIB_NAME, FDK.SOURCES, FDK.flash_decode_kernel_call)}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch the card audit holds against the build: where it comes
    from (a finding's location), the library and function it runs, its
    threads and its dynamic shared memory."""

    location: str
    library: str
    function: str
    threads: int
    smem_bytes: int


def lm_plans() -> list[LaunchPlan]:
    """B5's launches at :data:`DECODE_SHAPES` (and its combine where a
    plan has several partitions) and B4's at :data:`FM_SHAPE`."""
    from repro_torch.kernels.flash_decode import kernel as FDK
    from repro_torch.kernels.fm_interaction import kernel as FMK
    out = []
    for label, sh in DECODE_SHAPES.items():
        lay = FDK.plan(sh["b"], sh["hkv"], sh["g"], sh["d"], sh["s"], 2)
        loc = f"kernel={FDK.LIB_NAME} shape={label}"
        fn = f"flash_decode_mma_kernel<{sh['d'] // 16}>" if lay.mma \
            else f"flash_decode_kernel<bf16,{lay.gb}>"
        out.append(LaunchPlan(loc, FDK.LIB_NAME, fn, lay.threads,
                              lay.smem_bytes))
        if lay.n_parts > 1:
            out.append(LaunchPlan(loc, FDK.LIB_NAME, "flash_decode_combine",
                                  COMBINE_THREADS, 0))
    _, smem = FMK.plan(FM_SHAPE["f"], FM_SHAPE["k"])
    for dt in ("f32", "bf16"):
        out.append(LaunchPlan(f"kernel={FMK.LIB_NAME} shape=fm_serve_bulk",
                              FMK.LIB_NAME, f"fm_interaction_kernel<{dt}>",
                              FM_THREADS, smem))
    return out


# ---------------------------------------------------------------------------
# Per-path checks.
# ---------------------------------------------------------------------------

def _loc(spec, batch: int | None = None) -> str:
    return (f"path={spec.name}" if batch is None
            else f"path={spec.name} bucket={batch}")


def _device(params):
    return params["fr"]["layers"][0]["w"].device


def _check_tile(spec, cfg, tparams, rung, plan):
    findings = []
    modeled = (spec.bucket_bytes(cfg, tparams),
               spec.reserved_smem_bytes(cfg, tparams))
    launched = (plan.batch_bytes, plan.reserved_bytes)
    if modeled != launched:
        findings.append(Finding(
            "audit-tile-mismatch", _loc(spec, rung), 0,
            f"the bucket model says {modeled[0]} B an event and "
            f"{modeled[1]} B reserved, the {plan.design} plan the wrapper "
            f"launches {launched[0]} B and {launched[1]} B — the path's "
            "per_sample_bytes / reserved_bytes hooks and the kernel's plan "
            "have drifted; take the hooks from the plan the wrapper runs"))
    return findings


def _check_budget(spec, rung, plan, budget_bytes):
    problems = []
    if plan.smem_bytes > budget_bytes:
        problems.append(f"{plan.smem_bytes} B of shared memory over the "
                        f"{budget_bytes} B a block may opt into")
    if plan.threads > MAX_THREADS_PER_BLOCK or plan.threads % 32:
        problems.append(f"{plan.threads} threads (at most "
                        f"{MAX_THREADS_PER_BLOCK}, "
                        "whole warps)")
    if plan.design == "team" and plan.events_per_block \
            * plan.per_event_bytes + plan.reserved_bytes > plan.smem_bytes:
        problems.append(
            f"{plan.events_per_block} events x {plan.per_event_bytes} B + "
            f"{plan.reserved_bytes} B reserved exceed the block's "
            f"{plan.smem_bytes} B")
    if not problems:
        return []
    return [Finding(
        "audit-ladder-budget", _loc(spec, rung), 0,
        f"rung {rung} launches a {plan.design} plan that does not fit: "
        + "; ".join(problems) + " — the launch would be refused; shrink "
        "the plan or the ladder")]


def _check_int8(spec, weights):
    import torch

    from repro_torch.kernels.fused_jedinet import autotune as fj
    findings = []

    def bad(msg):
        findings.append(Finding("audit-int8-operands", _loc(spec), 0, msg))

    try:
        weights.pack()
    except TypeError as exc:
        bad(f"the bound weights do not pack: {exc}")
        return findings
    w, b = weights.wpack, weights.bpack
    if w.is_floating_point():
        bad(f"quantized path ships {w.dtype} weights — int8 paths carry an "
            "integer weight buffer; the weights were dequantized on the "
            "host, which forfeits weight_bytes=1's residency")
    elif w.element_size() != spec.weight_bytes:
        bad(f"the weight buffer has {w.element_size()} B an element, the "
            f"spec declares weight_bytes={spec.weight_bytes}")
    if b.dtype != torch.float32:
        bad(f"biases ship as {b.dtype}; they stay float32")
    n = len(fj.kernel_entries(weights.n_features, *weights.widths()))
    scales = weights.scales
    if scales is None or len(scales) != n:
        bad(f"{n} weight tensors in the kernel's entries, "
            f"{'no' if scales is None else len(scales)} scales — each "
            "tensor's fp32 scale folds into its sum exactly once")
    elif any(not isinstance(s, torch.Tensor) or s.numel() != 1
             or s.dtype != torch.float32 for s in scales):
        bad("a scale is not a float32 scalar")
    return findings


def _example_x(cfg, batch: int, device):
    import torch
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((batch, cfg.n_objects, cfg.n_features), generator=gen)
    return x.to(device=device, dtype=torch.bfloat16)


def _check_forward(spec, cfg, bound, batch, launcher, device):
    """The forward once on a bf16 x of ``batch`` events: fp32 logits and,
    on the card, exactly its own kernel's launch (the counts' difference
    over the call, so a caller's counts carry on)."""
    import torch
    counters = {k: wrapper for k, (_, _, wrapper) in kernels().items()}
    before = {k: w.launches for k, w in counters.items()}
    try:
        out = spec.forward(bound, cfg, _example_x(cfg, batch, device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except (RuntimeError, ValueError, TypeError) as exc:
        return [Finding("audit-forward-failure", _loc(spec, batch), 0,
                        f"the forward fails on {device.type}: "
                        f"{type(exc).__name__}: {exc}")]
    findings = []
    if out.dtype != torch.float32:
        findings.append(Finding(
            "audit-accum-dtype", _loc(spec, batch), 0,
            f"the forward on a bf16 x returns {out.dtype} logits, must be "
            "torch.float32 — sums stay fp32 and logits leave the kernel "
            "at full precision; cast at the edges, not the result"))
    if device.type == "cuda":
        moved = {k: w.launches - before[k] for k, w in counters.items()
                 if w.launches != before[k]}
        want = {launcher.kernel: 1} if launcher is not None else {}
        if moved != want:
            findings.append(Finding(
                "audit-containment", _loc(spec, batch), 0,
                f"one forward moved the launch counts by {moved or 'none'}, "
                f"the path (cuda={spec.cuda}) should move "
                f"{want or 'none'} — a kernel path launches its kernel once "
                "a batch, a plain path none"))
    return findings


def audit_path(spec, cfg, params, *, max_batch: int = 1024,
               budget_bytes: int = SMEM_OPT_IN,
               plans: list | None = None) -> list[Finding]:
    """The contract audit of one path at one config.  ``params`` are raw
    (on the device to audit on); the path's transform runs first, then
    its binding, so the audit sees the serving-time weights.  Each rung's
    launch is appended to ``plans`` (:class:`LaunchPlan`) for
    :func:`audit_build`."""
    findings: list[Finding] = []
    tparams = spec.prepare_params(params)
    ladder = spec.bucket_ladder(cfg, tparams, max_batch)
    if not ladder:
        return [Finding(
            "audit-ladder-budget", _loc(spec), 0,
            "bucket_ladder is empty — not even one event fits the block's "
            "shared memory after its reservation; the path cannot serve")]
    launcher = None
    if spec.cuda:
        launcher = launchers().get(spec.forward)
        if launcher is None:
            return [Finding(
                "audit-no-plan", _loc(spec), 0,
                "kernel path (cuda=True) whose launch plan the auditor "
                "cannot resolve — its bucket model, budget and registers "
                "go unchecked; add its forward to "
                "kernel_audit.launchers() with the plan its wrapper runs")]
    try:
        bound = spec.bind(tparams, cfg)
    except (ValueError, TypeError) as exc:
        return [Finding(
            "audit-int8-operands" if spec.quantized else "audit-no-plan",
            _loc(spec), 0, f"the params do not bind: {exc}")]
    if launcher is not None:
        weights = launcher.weights(bound)
        plan = launcher.plan(cfg, weights)
        function = launcher.function(plan, cfg)
        library = kernels()[launcher.kernel][0]
        for rung in ladder:
            findings += _check_tile(spec, cfg, tparams, rung, plan)
            findings += _check_budget(spec, rung, plan, budget_bytes)
            if plans is not None:
                plans.append(LaunchPlan(_loc(spec, rung), library, function,
                                        plan.threads, plan.smem_bytes))
        if spec.quantized:
            findings += _check_int8(spec, weights)
    findings += _check_forward(spec, cfg, bound, ladder[0], launcher,
                               _device(params))
    return findings


def audit_registry(cfg, params, *, max_batch: int = 1024, names=None,
                   budget_bytes: int = SMEM_OPT_IN,
                   plans: list | None = None) -> list[Finding]:
    """Every registered path (or the named subset) at one config, plus
    the registry's fallback chains."""
    from repro_torch.core import paths as registry
    findings: list[Finding] = []
    try:
        registry.validate_fallbacks()
    except ValueError as exc:
        findings.append(Finding(
            "audit-fallback-chain", "registry", 0,
            f"fallback-chain validation failed: {exc}"))
    for name in (names or registry.available()):
        findings += audit_path(registry.get(name), cfg, params,
                               max_batch=max_batch, budget_bytes=budget_bytes,
                               plans=plans)
    return findings


# ---------------------------------------------------------------------------
# The sources' constants and their Python mirrors.
# ---------------------------------------------------------------------------

def _int_expr(text: str) -> int:
    """An integer constant expression of ``+``, ``-`` and ``*``."""
    def ev(node):
        if isinstance(node, ast.Constant) and type(node.value) is int:
            return node.value
        if isinstance(node, ast.BinOp):
            a, b = ev(node.left), ev(node.right)
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
        raise ValueError(f"not an integer constant expression: {text!r}")
    return ev(ast.parse(text.strip(), mode="eval").body)


def _mirrors():
    """(Python name, value, source file, constexpr) of every constant
    the Python side keeps in step with a kernel source."""
    from repro_torch.kernels.flash_decode import kernel as FDK
    from repro_torch.kernels.fm_interaction import kernel as FMK
    from repro_torch.kernels.fused_jedinet import autotune as fj
    fd = "kernels/flash_decode/kernel.py"
    return [
        (f"{fd} SMEM_BUDGET", FDK.SMEM_BUDGET, "flash_decode.cu", "kMaxSmem"),
        (f"{fd} TILE", FDK.TILE, "flash_decode.cu", "kTile"),
        (f"{fd} MMA_TILE", FDK.MMA_TILE, "flash_decode.cu", "kMmaTile"),
        (f"{fd} STAGES", FDK.STAGES, "flash_decode.cu", "kStages"),
        (f"{fd} MAX_WORDS", FDK.MAX_WORDS, "flash_decode.cu", "kMaxWords"),
        (f"{fd} MAX_HEADS", FDK.MAX_HEADS, "flash_decode.cu", "kMaxHeads"),
        ("analysis/kernel_audit.py COMBINE_THREADS", COMBINE_THREADS,
         "flash_decode.cu", "kCombineThreads"),
        ("kernels/fm_interaction/kernel.py SMEM_BUDGET", FMK.SMEM_BUDGET,
         "fm_interaction.cu", "kMaxSmem"),
        ("analysis/kernel_audit.py FM_THREADS", FM_THREADS,
         "fm_interaction.cu", "kThreads"),
        ("kernels/fused_jedinet/autotune.py WARP_EDGE_REGS",
         fj.WARP_EDGE_REGS, "jedi_warp.cuh", "kEdgeRegs"),
    ]


def _src_loc(path: pathlib.Path) -> str:
    try:
        return path.relative_to(ROOT).as_posix()
    except ValueError:
        return str(path)


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def audit_sources(csrc: pathlib.Path = CSRC) -> list[Finding]:
    """``audit-source-mirror``: each Python mirror of a kernel source's
    constants (:func:`_mirrors`, B1's warp design's ``WARP_RPL`` /
    ``WARP_REG_WIDTHS``, the launch header's ``HEADER_FIELDS``) equals
    the source in ``csrc``."""
    from repro_torch.kernels.fused_jedinet import autotune as fj
    from repro_torch.kernels.fused_jedinet import full_kernel as FK
    csrc = pathlib.Path(csrc)
    findings: list[Finding] = []
    texts: dict[str, str] = {}

    def text(name):
        if name not in texts:
            texts[name] = (csrc / name).read_text()
        return texts[name]

    def bad(name, pos, msg):
        t = text(name)
        findings.append(Finding("audit-source-mirror", _src_loc(csrc / name),
                                _line_of(t, pos) if pos else 0, msg))

    for py, value, name, const in _mirrors():
        m = re.search(rf"\bconstexpr\s+[\w:]+\s+{const}\s*=\s*([^;]+);",
                      text(name))
        got = _int_expr(m.group(1)) if m else None
        if got != value:
            bad(name, m.start() if m else 0,
                f"{const} is {got if m else 'missing'} in the source, "
                f"{py} is {value} — the wrapper plans launches the kernel "
                "refuses or misreads; change both together")
    warp = text("jedi_warp.cuh")
    for fn, want in (("warp_rpl", fj.WARP_RPL),
                     ("warp_threads", fj.WARP_REG_WIDTHS)):
        m = re.search(rf"{fn}\(\)\s*\{{\s*return\s+RW\s*<=\s*(\d+)\s*\?\s*"
                      rf"(\d+)\s*:\s*(\d+)\s*;", warp)
        got = None if m is None else {
            rw: int(m.group(2)) if rw <= int(m.group(1)) else int(m.group(3))
            for rw in want}
        if got != want:
            bad("jedi_warp.cuh", m.start() if m else 0,
                f"{fn}<RW>() gives {got if m else 'nothing readable'}, "
                f"autotune.py's mirror {want} — B1's / B3's plans and the "
                "kernels' launch bounds disagree")
    common = text("jedi_common.cuh")
    lo, hi = common.find("HEADER-FIELDS-BEGIN"), common.find("HEADER-FIELDS-END")
    fields = tuple(re.findall(r"F\((\w+)\)", common[lo:hi])) \
        if 0 <= lo < hi else ()
    if fields != FK.HEADER_FIELDS:
        bad("jedi_common.cuh", max(lo, 0),
            f"the launch header's fields are {list(fields)} in the source, "
            f"{list(FK.HEADER_FIELDS)} in full_kernel.HEADER_FIELDS — every "
            "JEDI launch would read its header shifted")
    return findings


# ---------------------------------------------------------------------------
# The card: the build's reports against the plans.
# ---------------------------------------------------------------------------

def read_build() -> dict[str, dict]:
    """Build B1-B5 (one ``nvcc`` each, in parallel; a built library is
    reused) and read each library's ptxas report, resource usage and SASS:
    ``{library: {"ptxas": .., "resources": .., "sass": ..}}``.  Raises
    when ``cuobjdump`` (from ``nvcc``'s toolkit) is missing or fails."""
    from repro_torch.kernels import build
    libs = [(name, sources) for name, sources, _ in kernels().values()]
    tool = pathlib.Path(build.find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool}); the "
                           "card audit reads the SASS with it")

    def one(lib):
        path = build.build_library(*lib)
        dumps = []
        for flag in ("--dump-resource-usage", "-sass"):
            res = subprocess.run([str(tool), flag, str(path)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"cuobjdump {flag} {path.name} failed: "
                                   f"{res.stderr.strip()}")
            dumps.append(res.stdout)
        return {"ptxas": parse_ptxas(build.build_log(*lib)),
                "resources": parse_resource_usage(dumps[0]),
                "sass": parse_sass(dumps[1])}

    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        return dict(zip((name for name, _ in libs), pool.map(one, libs)))


def check_plans(built: dict[str, dict], plans: list[LaunchPlan],
                stats: dict | None = None) -> list[Finding]:
    """``audit-registers`` and ``audit-smem``: each plan's function is in
    its library's ptxas report, its block's registers (each warp's
    rounded up to :data:`REGISTER_UNIT`) fit :data:`REGISTER_FILE`, and
    its static plus dynamic shared memory fits :data:`SMEM_OPT_IN`.
    ``stats["tightest_registers"]`` gets the largest allocation."""
    findings: list[Finding] = []
    tightest = None
    for p in plans:
        lib = built.get(p.library, {})
        entry = lib.get("ptxas", {}).get(p.function)
        if entry is None or entry.registers is None:
            findings.append(Finding(
                "audit-registers", p.location, 0,
                f"{p.library} has no ptxas report of {p.function}, the "
                "function this plan launches — the plan names a kernel "
                "the build does not have"))
            continue
        alloc = allocated_registers(entry.registers, p.threads)
        if tightest is None or alloc > tightest[0]:
            tightest = (alloc, p)
        if alloc > REGISTER_FILE:
            findings.append(Finding(
                "audit-registers", p.location, 0,
                f"{p.function}: {entry.registers} registers x {p.threads} "
                f"threads take {alloc} of the SM's {REGISTER_FILE} (a warp's "
                f"rounded up to {REGISTER_UNIT}) — the launch fails with "
                "too many resources; cap the registers (__launch_bounds__) "
                "or launch fewer threads"))
        # cuobjdump's SHARED counts the 1 KB the card reserves for every
        # block (each of the port's kernels, none with static shared
        # memory, reads 1,024): the opt-in limit is on what lies above it
        static = lib.get("resources", {}).get(p.function, {}).get(
            "SHARED", SMEM_RESERVED)
        if static + p.smem_bytes > SMEM_OPT_IN + SMEM_RESERVED:
            findings.append(Finding(
                "audit-smem", p.location, 0,
                f"{p.function}: {static - SMEM_RESERVED} B static + "
                f"{p.smem_bytes} B dynamic shared memory exceed the "
                f"{SMEM_OPT_IN} B a block may opt into"))
    if stats is not None and tightest is not None:
        alloc, p = tightest
        stats["tightest_registers"] = {
            "allocated": alloc, "of": REGISTER_FILE,
            "share": alloc / REGISTER_FILE, "function": p.function,
            "threads": p.threads, "plan": p.location}
    return findings


def check_spills(ptxas: dict[str, PtxasEntry],
                 required=None) -> list[Finding]:
    """``audit-spills``: each function of ``required`` (default
    :data:`NO_SPILL` and every ``jedi_linear_rows_kernel``) is in
    ``ptxas`` and spills nothing."""
    if required is None:
        rows = sorted(f for f in ptxas if f.startswith(NO_SPILL_PREFIX))
        required = (*NO_SPILL, *(rows or [NO_SPILL_PREFIX + "...>"]))
    findings = []
    for fn in required:
        if fn not in ptxas:
            findings.append(Finding(
                "audit-spills", f"function={fn}", 0,
                f"no ptxas report of {fn}, a design that must not spill"))
        elif ptxas[fn].spill_bytes:
            findings.append(Finding(
                "audit-spills", f"function={fn}", 0,
                f"{fn} spills {ptxas[fn].spill_bytes} B — a register-"
                "resident design that spills runs from local memory; "
                "narrow its register width or its receivers a lane"))
    return findings


def check_sass(library: str, sass: dict[str, list[str]]) -> list[Finding]:
    """``audit-accum-dtype`` on one library's SASS (:func:`parse_sass`):
    every tensor-core instruction accumulates in F32."""
    return [Finding(
        "audit-accum-dtype", f"kernel={library} function={fn}", 0,
        f"{op} accumulates in {accumulator(op) or '?'}, must be F32 — a "
        "tensor-core sum in a narrower type breaks the kernel's "
        "tolerance; accumulate in fp32 and round after")
        for fn, ops in sass.items() for op in ops if accumulator(op) != "F32"]


def audit_build(built: dict[str, dict], plans: list[LaunchPlan],
                stats: dict | None = None) -> list[Finding]:
    """The card's checks of the build ``built`` (:func:`read_build`)
    against ``plans``: registers and shared memory
    (:func:`check_plans`), spills (:func:`check_spills`) and the tensor
    cores' accumulator (:func:`check_sass`; B5 must have some).
    ``stats`` receives what was read and the tightest register margin."""
    from repro_torch.kernels.flash_decode import kernel as FDK
    findings = check_plans(built, plans, stats)
    ptxas = {fn: e for lib in built.values() for fn, e in lib["ptxas"].items()}
    findings += check_spills(ptxas)
    for name, lib in built.items():
        findings += check_sass(name, lib["sass"])
    if not any(built.get(FDK.LIB_NAME, {}).get("sass", {}).values()):
        findings.append(Finding(
            "audit-accum-dtype", f"kernel={FDK.LIB_NAME}", 0,
            "no HMMA in flash_decode's SASS — its tensor-core path is gone "
            "or the SASS was not read"))
    if stats is not None:
        stats["ptxas_functions"] = {
            name: sum(e.registers is not None for e in lib["ptxas"].values())
            for name, lib in built.items()}
        stats["hmma_checked"] = sum(len(ops) for lib in built.values()
                                    for ops in lib["sass"].values())
    return findings


# ---------------------------------------------------------------------------
# Entry point.
# ---------------------------------------------------------------------------

def run(configs: dict, *, max_batch: int = 1024, names=None,
        budget_bytes: int = SMEM_OPT_IN,
        csrc: pathlib.Path = CSRC) -> tuple[list[Finding], dict]:
    """The whole audit of ``configs`` (``{arch: (cfg, params)}``, all
    params on one device): the CPU checks at every config, and on a CUDA
    device the build's and the containment checks.  Returns the findings
    and what was audited."""
    from repro_torch.core import paths as registry
    t0 = time.perf_counter()
    findings = audit_sources(csrc)
    plans: list[LaunchPlan] = []
    stats: dict = {"audited": {}}
    device = None
    for arch, (cfg, params) in configs.items():
        device = _device(params)
        before = len(plans)
        findings += audit_registry(cfg, params, max_batch=max_batch,
                                   names=names, budget_bytes=budget_bytes,
                                   plans=plans)
        audited = plans[before:]
        stats["audited"][arch] = {
            "paths": len(names or registry.available()),
            "kernel_paths": len({p.location.split()[0] for p in audited}),
            "path_rungs": len(audited)}
    stats["device"] = device.type if device is not None else "none"
    if device is not None and device.type == "cuda":
        findings += audit_build(read_build(), plans + lm_plans(), stats)
    else:
        stats["card_checks"] = ("not run: registers, shared memory, spills, "
                                "SASS and containment need the card")
    stats["seconds"] = time.perf_counter() - t0
    return findings, stats
