"""First-class forward-path registry: one declarative API per path.

Port of ``repro.core.paths``.  A :class:`PathSpec` bundles everything a
forward path is — the forward fn, its numerical reference, its fusion
level, supported compute dtypes, an optional params transform (e.g.
int8 quantization), its bucket policy (the kernel's shared-memory
model) and its fallback — so the serving engine, the CLI
and the tests all introspect one object.

``cuda`` replaces the reference's ``pallas`` flag: it marks a path that
runs a hand-written CUDA kernel on the card (and its plain PyTorch
version on the CPU).  A fallback chain must end in a non-kernel path.

Built-in paths live in :data:`_BUILTIN_MODULES` and are imported on
first registry access, so importing this module does no torch work.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Sequence

#: Fusion tiers, in increasing order: "none" round-trips B/E through
#: device memory, "edge" keeps them on-chip, "full" keeps every
#: intermediate on-chip.
FUSED_LEVELS = ("none", "edge", "full")

#: Aggregation classes in N_o: the dense pairwise grid, or JEDI-linear's
#: pooled O(N) aggregation.
COMPLEXITY_CLASSES = ("O(N^2)", "O(N)")


@dataclasses.dataclass(frozen=True)
class PathSpec:
    """Everything one forward path is, in one declarative object.

    ``forward`` / ``ref`` share the signature ``(params, cfg, x) ->
    logits``.  When ``transform_params`` is set, BOTH receive the
    transformed params; the hook runs once, at bind time.
    ``bind_params`` (optional) turns those params into the form the
    forward consumes fastest — for the kernel paths: split, flattened,
    packed and resident on the device — and runs once per compiled
    bucket; ``forward`` accepts both forms.
    """

    name: str
    forward: Callable                       # (params, cfg, x) -> logits
    ref: Callable                           # numerical oracle, same signature
    fused_level: str = "none"               # fusion tier (FUSED_LEVELS)
    cuda: bool = False                      # hand-written CUDA kernel path
    compute_dtypes: tuple = ("float32", "bfloat16")
    transform_params: Callable | None = None   # params -> params (quantize)
    bind_params: Callable | None = None     # (params, cfg) -> bound params
    tolerance: float = 2e-4                 # max |forward - ref| in fp32
    quantized: bool = False                 # tag: weights are sub-fp32
    weight_bytes: int | None = None         # weight precision in device memory
    per_sample_bytes: Callable | None = None   # (cfg, params) -> smem B/event
    reserved_bytes: Callable | None = None  # (cfg, params) -> smem B/block
    flops_model: Callable | None = None     # (cfg, batch) -> FLOPs of one step
    fallback: str | None = None             # degrade-to path (fallback_chain)
    complexity: str = "O(N^2)"              # aggregation class
    description: str = ""

    def __post_init__(self):
        if self.fused_level not in FUSED_LEVELS:
            raise ValueError(
                f"path {self.name!r}: fused_level {self.fused_level!r} "
                f"not in {FUSED_LEVELS}")
        if self.complexity not in COMPLEXITY_CLASSES:
            raise ValueError(
                f"path {self.name!r}: complexity {self.complexity!r} "
                f"not in {COMPLEXITY_CLASSES}")

    # -- hooks with defaults -------------------------------------------------

    def prepare_params(self, params):
        """Apply the params-transform hook (identity when none)."""
        if self.transform_params is None:
            return params
        return self.transform_params(params)

    def bind(self, params, cfg):
        """Params in the form ``forward`` consumes fastest (identity when
        the path declares no ``bind_params``)."""
        if self.bind_params is None:
            return params
        return self.bind_params(params, cfg)

    def supports_dtype(self, compute_dtype: str) -> bool:
        return compute_dtype in self.compute_dtypes

    def bucket_bytes(self, cfg, params) -> int:
        """Per-event shared-memory bytes of the path's kernel, which
        drive the serving bucket ladder: the ``per_sample_bytes`` hook,
        else the whole-network kernel's (B1) team layout."""
        if self.per_sample_bytes is not None:
            return int(self.per_sample_bytes(cfg, params))
        from repro_torch.kernels.fused_jedinet import autotune
        return autotune.layout_for(cfg, params).per_event_bytes

    def reserved_smem_bytes(self, cfg, params) -> int:
        """Shared memory a block spends before its first event: the
        weights (upcast to fp32 as they land) and the per-team scratch;
        the ``reserved_bytes`` hook, else B1's team layout.  ``params`` must
        already be transformed (:meth:`prepare_params`)."""
        if self.reserved_bytes is not None:
            return int(self.reserved_bytes(cfg, params))
        from repro_torch.kernels.fused_jedinet import autotune
        return autotune.layout_for(cfg, params).reserved_bytes

    def bucket_ladder(self, cfg, params, max_batch: int,
                      budget_bytes: int | None = None) -> list[int]:
        """The serving pad-to-bucket ladder this path earns, from
        :func:`repro_torch.kernels.autotune.bucket_ladder` under the
        path's own per-event bytes and reservation."""
        from repro_torch.kernels import autotune
        kw = {} if budget_bytes is None else {"budget_bytes": budget_bytes}
        return autotune.bucket_ladder(
            max_batch, self.bucket_bytes(cfg, params),
            reserved_bytes=self.reserved_smem_bytes(cfg, params), **kw)

    def flops_for(self, cfg, batch: int) -> float:
        """Modeled FLOPs of one batched forward step through this path:
        the ``flops_model`` hook (O(N) paths plug in
        ``codesign.jedi_linear_flops``), else the dense edge-grid model
        (``codesign.H100Model.flops``)."""
        if self.flops_model is not None:
            return float(self.flops_model(cfg, batch))
        from repro_torch.core import codesign
        return float(codesign.H100Model.flops(cfg, batch))

    def roofline_for(self, cfg, buckets, *, compute_bytes: int = 2,
                     chips: int = 1) -> dict:
        """H100Model roofline per bucket at this path's declared fusion
        level, weight precision and FLOPs model."""
        from repro_torch.core import codesign
        return codesign.bucket_roofline(
            cfg, buckets, level=self.fused_level,
            compute_bytes=compute_bytes, chips=chips,
            weight_bytes=self.weight_bytes, flops_fn=self.flops_model)


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, PathSpec] = {}

_BUILTIN_MODULES = (
    "repro_torch.core.interaction_net",
    "repro_torch.core.int8_path",
    "repro_torch.core.jedi_linear_path",
)
_builtins_state = "pending"           # "pending" -> "loading" -> "done"


def _ensure_builtins() -> None:
    global _builtins_state
    if _builtins_state != "pending":  # "loading": modules re-enter via register
        return
    _builtins_state = "loading"
    try:
        for mod in _BUILTIN_MODULES:
            importlib.import_module(mod)
    except Exception:
        # don't latch a silently partial registry: the next access retries
        _builtins_state = "pending"
        raise
    _builtins_state = "done"


def register(spec: PathSpec, *, overwrite: bool = False) -> PathSpec:
    """Register a :class:`PathSpec`; returns it for chaining."""
    if not overwrite and spec.name in _REGISTRY:
        raise ValueError(f"forward path {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def register_path(name: str | None = None, **fields):
    """Decorator: register the decorated fn as a forward path.  ``name``
    defaults to the fn's ``__name__`` without a leading ``forward_``."""
    def deco(fn):
        pname = name or fn.__name__.removeprefix("forward_")
        register(PathSpec(name=pname, forward=fn, **fields))
        return fn
    return deco


def get(name: str) -> PathSpec:
    """The spec for ``name``; raises ValueError listing the choices."""
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown forward path {name!r}; "
            f"available: {', '.join(sorted(_REGISTRY))}") from None


def specs(**tags: Any) -> list[PathSpec]:
    """All registered specs, sorted by name, filtered by spec fields
    (``specs(quantized=True)``, ``specs(cuda=False)``); unknown field
    names raise."""
    _ensure_builtins()
    for k in tags:
        if k not in PathSpec.__dataclass_fields__:
            raise ValueError(f"unknown PathSpec filter field {k!r}")
    return [s for _, s in sorted(_REGISTRY.items())
            if all(getattr(s, k) == v for k, v in tags.items())]


def available(**tags: Any) -> list[str]:
    """Names of all registered paths (sorted), filtered like :func:`specs`."""
    return [s.name for s in specs(**tags)]


def fallback_chain(name: str) -> list[str]:
    """The degradation ladder rooted at ``name``: ``[name, fallback, ...]``
    down to a terminal path.

    Every link must resolve, the chain must not cycle, and the terminal
    rung must be a non-kernel path — plain PyTorch cannot fail to build
    the way a hand-written kernel can, so the bottom rung always serves.
    Raises ``ValueError`` on any violation.
    """
    chain, seen = [], set()
    cur: str | None = name
    while cur is not None:
        if cur in seen:
            raise ValueError(
                f"fallback chain of {name!r} cycles at {cur!r}: "
                f"{' -> '.join(chain + [cur])}")
        spec = get(cur)        # raises listing choices on unknown links
        chain.append(cur)
        seen.add(cur)
        cur = spec.fallback
    terminal = get(chain[-1])
    if terminal.cuda:
        raise ValueError(
            f"fallback chain of {name!r} terminates in CUDA kernel path "
            f"{terminal.name!r} ({' -> '.join(chain)}); chains must end "
            "in a non-kernel reference path so the degradation ladder "
            "always has a servable bottom rung")
    return chain


def terminal_rung(name: str) -> str:
    """The non-kernel reference path at the bottom of ``name``'s chain."""
    return fallback_chain(name)[-1]


def validate_fallbacks() -> dict[str, list[str]]:
    """``{name: chain}`` for every registered path; raises on the first
    broken chain."""
    return {name: fallback_chain(name) for name in available()}


def describe(names: Sequence[str] | None = None, *, cfg=None, params=None,
             max_batch: int = 1024) -> str:
    """Human-readable registry table (the CLI's ``--list-paths``).

    Given a ``cfg`` and raw ``params``, each path's resolved bucket
    policy is appended: per-event shared-memory bytes, the block's
    reservation and the ladder it earns for ``max_batch``.
    """
    rows = [get(n) for n in (names if names is not None else available())]
    lines = [f"{'path':<22} {'level':<5} {'cmplx':<6} {'kernel':<7} "
             f"{'dtypes':<18} {'wB':<3} {'tol':<7} "
             f"{'fallback chain':<34} description"]
    for s in rows:
        kind = "cuda" if s.cuda else "torch"
        if s.quantized:
            kind += "+q"
        wb = "-" if s.weight_bytes is None else str(s.weight_bytes)
        try:
            chain = fallback_chain(s.name)
            fb = ">".join(chain[1:]) if len(chain) > 1 else "-"
        except ValueError as e:          # surface broken chains, don't crash
            fb = f"!invalid ({e})"
        lines.append(
            f"{s.name:<22} {s.fused_level:<5} {s.complexity:<6} {kind:<7} "
            f"{','.join(s.compute_dtypes):<18} {wb:<3} {s.tolerance:<7.0e} "
            f"{fb:<34} {s.description}")
    if cfg is not None and params is not None:
        lines.append("")
        lines.append(f"bucket policy @ n_objects={cfg.n_objects} "
                     f"max_batch={max_batch} (per-path shared-memory model):")
        lines.append(f"{'path':<22} {'B/sample':>9} {'reservedB':>10} ladder")
        for s in rows:
            p = s.prepare_params(params)
            ladder = s.bucket_ladder(cfg, p, max_batch)
            lines.append(
                f"{s.name:<22} {s.bucket_bytes(cfg, p):>9} "
                f"{s.reserved_smem_bytes(cfg, p):>10} "
                f"{','.join(str(b) for b in ladder)}")
    return "\n".join(lines)
