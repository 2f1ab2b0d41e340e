"""Algorithm-hardware co-design (Sec. 4.2-4.4 of the paper), for the H100.

Port of ``repro.core.codesign``.  Two analytic performance models drive
the design-space exploration:

* ``FPGAModel`` — the paper's own resource model (eq. 1) and latency
  model (eq. 2) for the fused layer-wise HLS architecture on a Xilinx
  U250.  It is backend-free and copied from the reference as it is: it
  regenerates the II / latency columns of Table 2.

* ``H100Model`` — the counterpart of the reference's ``TPUModel``: a
  roofline estimate (compute, HBM traffic) of a *batched* JEDI-net
  inference step on one NVIDIA H100 SXM5 (and, in ``lm_decode_step``,
  the work of one dense-LM decode step).  ``flops`` and ``hbm_bytes``
  are the reference's unchanged — they count the model's work, not the
  chip's; ``evaluate`` divides them by the H100's peaks.  The compute
  peak depends on the operand width (``compute_bytes``): fp32 runs on
  the CUDA cores at 67 TFLOP/s, bf16 on the tensor cores at 989 TFLOP/s
  dense, 15x apart, where a TPU's MXU has one bf16 peak.

The DSE (``explore``) enumerates (f_R NL/size, f_O first-layer size,
N_fR) candidates, prunes by alpha x latency budget *before* any
training, and returns Opt-Latn / Opt-Acc picks per the paper's
J4/J5/U4/U5 selection rule.  Each candidate's ``gpu`` field (the
reference's ``tpu``) holds its H100 roofline.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Sequence

from repro_torch.core.interaction_net import JediNetConfig

# --- hardware constants ----------------------------------------------------

U250_DSPS = 12288            # Table 1
FPGA_CLOCK_NS = 5.0          # 200 MHz (Sec. 5.1)

#: One NVIDIA H100 SXM5, from NVIDIA's "H100 Tensor Core GPU" datasheet
#: (SXM5 column): FP32 on the CUDA cores, BF16 on the tensor cores
#: without sparsity (1,979 TFLOP/s is the sparse figure), HBM3 bandwidth
#: and NVLink bandwidth per GPU.
H100_FP32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_HBM_BPS = 3.35e12
H100_NVLINK_BPS = 900e9

#: Compute peak by operand width in bytes.
H100_PEAK_FLOPS = {4: H100_FP32_FLOPS, 2: H100_BF16_FLOPS}


# ---------------------------------------------------------------------------
# FPGA model (faithful): eq. (1) DSPs + eq. (2) latency.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FPGADesignPoint:
    cfg: JediNetConfig
    n_fr: int                 # copies of the f_R unit (N_fR)
    r_fo: int = 1             # reuse factor of f_O
    r_phi: int = 1            # reuse factor of phi_O
    ii_mult: int = 1          # II of a DSP multiplier (1 cycle, Sec 4.3)

    # Pipeline-depth constants of eq. (2).  DP_loop + DP_tail is dominated by
    # the depth of the fused stage: each GEMM stage adds a few register
    # stages.  Calibrated on the paper's own J4/J5/U4/U5 estimates
    # (0.30/0.91/0.66/0.915 us -> depths 29..37 for 7..11 MLP matmul stages).
    dp_per_matmul: float = 2.0
    dp_base: float = 11.0


class FPGAModel:
    """Eq. (1) resource + eq. (2) latency model."""

    @staticmethod
    def mlp_layer_dims(cfg: JediNetConfig):
        from repro_torch.nn.core import mlp_dims
        return {
            "fr": mlp_dims(2 * cfg.n_features, list(cfg.fr_hidden), cfg.d_e),
            "fo": mlp_dims(cfg.n_features + cfg.d_e, list(cfg.fo_hidden), cfg.d_o),
            "phi": mlp_dims(cfg.d_o, list(cfg.phi_hidden), cfg.n_targets),
        }

    @classmethod
    def dsp_count(cls, pt: FPGADesignPoint) -> int:
        """eq. (1): DSP_layer = FC_in*FC_out / R_NN, summed, x N_NN copies."""
        dims = cls.mlp_layer_dims(pt.cfg)
        reuse = {"fr": 1, "fo": pt.r_fo, "phi": pt.r_phi}   # R_fR == 1 always
        copies = {"fr": pt.n_fr, "fo": 1, "phi": 1}
        total = 0
        for nn_name, layer_dims in dims.items():
            per_copy = sum(math.ceil(din * dout / reuse[nn_name])
                           for din, dout in layer_dims)
            total += per_copy * copies[nn_name]
        return total

    @classmethod
    def latency_cycles(cls, pt: FPGADesignPoint) -> dict:
        """eq. (2): II and end-to-end latency of the fused design, in cycles."""
        cfg = pt.cfg
        n_o = cfg.n_objects
        ii_loop = pt.ii_mult * max(
            math.ceil((n_o - 1) / pt.n_fr), pt.r_fo, pt.r_phi)
        ii_model = ii_loop * n_o
        dims = cls.mlp_layer_dims(cfg)
        n_matmuls = sum(len(d) for d in dims.values())
        dp = pt.dp_per_matmul * n_matmuls + pt.dp_base
        latency = ii_loop * (n_o - 1) + dp
        return {
            "ii_loop": ii_loop,
            "ii_cycles": ii_model,
            "latency_cycles": latency,
            "ii_us": ii_model * FPGA_CLOCK_NS / 1e3,
            "latency_us": latency * FPGA_CLOCK_NS / 1e3,
        }

    @classmethod
    def evaluate(cls, pt: FPGADesignPoint) -> dict:
        out = cls.latency_cycles(pt)
        out["dsp"] = cls.dsp_count(pt)
        out["dsp_util"] = out["dsp"] / U250_DSPS
        out["fits"] = out["dsp"] <= U250_DSPS
        return out


# ---------------------------------------------------------------------------
# H100 model (adaptation): roofline estimate for a batched inference step.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class H100DesignPoint:
    cfg: JediNetConfig
    batch: int = 1024
    chips: int = 1
    compute_bytes: int = 2    # 2: bf16 on the tensor cores; 4: fp32


def peak_flops(compute_bytes: int) -> float:
    """The H100's compute peak for operands of ``compute_bytes`` bytes."""
    try:
        return H100_PEAK_FLOPS[compute_bytes]
    except KeyError:
        raise ValueError(
            f"no H100 compute peak for {compute_bytes}-byte operands; "
            f"choose one of {sorted(H100_PEAK_FLOPS)}") from None


class H100Model:
    """Roofline (compute, HBM) for one batched JEDI-net inference."""

    @staticmethod
    def flops(cfg: JediNetConfig, batch: int) -> float:
        from repro_torch.nn.core import mlp_dims
        n_e, n_o = cfg.n_edges, cfg.n_objects
        f = 0.0
        for din, dout in mlp_dims(2 * cfg.n_features, list(cfg.fr_hidden), cfg.d_e):
            f += 2.0 * n_e * din * dout
        for din, dout in mlp_dims(cfg.n_features + cfg.d_e, list(cfg.fo_hidden), cfg.d_o):
            f += 2.0 * n_o * din * dout
        for din, dout in mlp_dims(cfg.d_o, list(cfg.phi_hidden), cfg.n_targets):
            f += 2.0 * din * dout
        # strength-reduced MMM3 adds: D_e * N_E (Fig. 8) — negligible but real.
        f += cfg.d_e * n_e
        return f * batch

    # O(N) paths override this via PathSpec.flops_model = jedi_linear_flops.

    @staticmethod
    def hbm_bytes(cfg: JediNetConfig, batch: int, compute_bytes: int,
                  level: str = "edge", *,
                  weight_bytes: int | None = None) -> float:
        """HBM traffic: weights once per step + activation round-trips.

        ``level`` is a :data:`~repro_torch.core.paths.FUSED_LEVELS` tier:

        * ``"none"`` — unfused path: B and E round-trip through HBM;
        * ``"edge"`` — edge-only kernel: B/E stay on-chip, Ebar and O
          still cross the kernel boundary through device memory;
        * ``"full"`` — whole-network kernel: weights + x in, logits out.

        Each tier removes one band of activation traffic (what the
        fused-vs-unfused §Perf iteration measures).  ``weight_bytes``
        overrides the weight precision independently of the activation
        ``compute_bytes`` — quantized paths (int8 weights, fp32
        accumulation) bill 1 B/weight while activations stay wide.

        The legacy ``fused: bool | str`` argument is gone: ``False``
        used to coerce surprisingly (a falsy level is not a fusion
        statement), so anything but an exact tier name now raises.
        """
        from repro_torch.core.paths import FUSED_LEVELS
        from repro_torch.nn.core import mlp_dims
        if level not in FUSED_LEVELS:
            raise ValueError(
                f"fused level must be one of {FUSED_LEVELS}, got {level!r}")
        cfgs = [
            mlp_dims(2 * cfg.n_features, list(cfg.fr_hidden), cfg.d_e),
            mlp_dims(cfg.n_features + cfg.d_e, list(cfg.fo_hidden), cfg.d_o),
            mlp_dims(cfg.d_o, list(cfg.phi_hidden), cfg.n_targets),
        ]
        w = sum((din * dout + dout) for dims in cfgs for din, dout in dims)
        traffic = w * (compute_bytes if weight_bytes is None else weight_bytes)
        n_e, n_o = cfg.n_edges, cfg.n_objects
        act = n_o * cfg.n_features                     # input
        act += cfg.n_targets                           # logits
        if level in ("none", "edge"):
            act += n_o * cfg.d_e                       # Ebar kernel<->torch
            act += n_o * cfg.d_o                       # O
        if level == "none":
            act += 2 * (n_e * 2 * cfg.n_features)      # B write + read
            act += 2 * (n_e * cfg.d_e)                 # E write + read
        return traffic + act * batch * compute_bytes

    @staticmethod
    def lm_decode_step(cfg, batch: int, t: int) -> tuple[float, float]:
        """(FLOPs, HBM bytes) of one LM decode step: ``batch`` tokens
        against a KV cache of ``t`` slots (``cfg`` a ``TransformerConfig``;
        weights and cache in its compute dtype, as ``serving/lm.py`` holds
        them).

        Bytes count each input once: every weight matrix (the LM head
        once, tied or not), the norm scales in fp32,
        the embedding rows of this step's tokens, the whole K / V cache
        (all ``t`` slots, empty ones too: the reference's attention and
        kernel B5 both read them) and ``slot_pos``; and each output
        once: this step's K / V rows and the fp32 logits.  FLOPs: 2 per
        multiply-add of the dense products and of the scores and the PV
        product over the ``t`` slots.

        An MoE layer (``cfg.moe``) counts its router (``d x E``) and the
        three matrices of EVERY expert, since the capacity dispatch runs
        all ``E`` expert products whatever the routing, and the FLOPs of
        the ``E x c`` capacity rows (``c = models.moe.capacity(batch)``:
        8 at 16 slots, 512 rows for 96 assignments); Arctic's dense
        residual FFN is counted as a dense layer's."""
        from repro_torch.models.moe import capacity
        d, hd, f, n = cfg.d_model, cfg.head_dim_, cfg.d_ff, cfg.n_layers
        elem = 2 if cfg.compute_dtype == "bfloat16" else 4
        n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
        vocab = -(-cfg.vocab_size // 256) * 256          # padded vocab
        ffn_w = 3 * d * f
        # the products every token of the step runs
        token_w = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
        layer_w, layer_flops = token_w, 0
        if cfg.moe is None or cfg.moe.dense_residual:
            token_w += ffn_w
            layer_w += ffn_w
        if cfg.moe is not None:
            e = cfg.moe.n_experts
            token_w += d * e                             # the router
            layer_w += d * e + e * ffn_w
            layer_flops = 2 * e * capacity(batch, cfg.moe) * ffn_w
        attn = 2 * 2 * n_q * hd * t
        flops = n * (batch * (2 * token_w + attn) + layer_flops) \
            + batch * 2 * d * vocab
        weights = (n * layer_w + d * vocab + batch * d) * elem \
            + (2 * n + 1) * d * 4
        kv = 2 * n * batch * n_kv * hd * elem
        nbytes = weights + kv * (t + 1) + 4 * batch * t + 4 * batch * vocab
        return float(flops), float(nbytes)

    @classmethod
    def evaluate(cls, pt: H100DesignPoint, level: str = "edge", *,
                 weight_bytes: int | None = None,
                 flops_fn: Callable | None = None) -> dict:
        """``flops_fn`` — per-path FLOPs model ``(cfg, batch) -> float``
        (``PathSpec.flops_model``); ``None`` uses the dense edge-grid
        :meth:`flops`.  O(N) paths plug in :func:`jedi_linear_flops` so
        the compute term of the roofline matches their algorithmic
        class — at N_o=128 the two differ by ~40x.  The compute peak is
        :func:`peak_flops` of ``pt.compute_bytes``."""
        fl = (flops_fn or cls.flops)(pt.cfg, pt.batch)
        by = cls.hbm_bytes(pt.cfg, pt.batch, pt.compute_bytes, level,
                           weight_bytes=weight_bytes)
        peak = peak_flops(pt.compute_bytes)
        t_c = fl / (pt.chips * peak)
        t_m = by / (pt.chips * H100_HBM_BPS)
        return {
            "flops": fl,
            "hbm_bytes": by,
            "compute_s": t_c,
            "memory_s": t_m,
            "step_us": max(t_c, t_m) * 1e6,
            "bound": "compute" if t_c >= t_m else "memory",
            "arithmetic_intensity": fl / by,
            "fused_level": level,
            "weight_bytes": pt.compute_bytes if weight_bytes is None
            else weight_bytes,
            "compute_bytes": pt.compute_bytes,
            "peak_flops": peak,
        }


def jedi_linear_flops(cfg: JediNetConfig, batch: int) -> float:
    """FLOPs of one batched JEDI-linear forward (O(N_o) aggregation).

    The pooled identity (``kernels/jedi_linear/ref.py``) moves the
    sender sum in front of f_R's first nonlinearity, so EVERY f_R layer
    runs over N_o node rows instead of N_E = N_o(N_o-1) edge rows — the
    first-layer GEMM cost is unchanged (the split halves sum to one
    (2P x H1) projection over N_o rows) and the pool + recombination
    add only ~4 N_o H1 elementwise ops.  f_O / phi_O are identical to
    the dense model.  The per-path FLOPs hook of the jedi_linear specs
    (``PathSpec.flops_model``).
    """
    from repro_torch.nn.core import mlp_dims
    n_o = cfg.n_objects
    f = 0.0
    for din, dout in mlp_dims(2 * cfg.n_features, list(cfg.fr_hidden),
                              cfg.d_e):
        f += 2.0 * n_o * din * dout
    for din, dout in mlp_dims(cfg.n_features + cfg.d_e, list(cfg.fo_hidden),
                              cfg.d_o):
        f += 2.0 * n_o * din * dout
    for din, dout in mlp_dims(cfg.d_o, list(cfg.phi_hidden), cfg.n_targets):
        f += 2.0 * din * dout
    # sender pool + (N_o-1)-recombination: ~4 elementwise ops per (node, H1)
    h1 = (list(cfg.fr_hidden) + [cfg.d_e])[0]
    f += 4.0 * n_o * h1
    return f * batch


def bucket_roofline(cfg: JediNetConfig, buckets, *, level: str = "full",
                    compute_bytes: int = 2, chips: int = 1,
                    weight_bytes: int | None = None,
                    flops_fn: Callable | None = None) -> dict:
    """H100Model roofline per serving bucket size.

    The batcher pads requests up to ladder buckets, so the question "what
    should this dispatch cost?" is per BUCKET, not per request: small
    buckets are weight-traffic (memory) bound — every padded row rides a
    fixed HBM bill — while large buckets amortize weights and go
    compute-bound.  Returns ``{bucket: evaluate() dict + per_event_us}``;
    the crossover is where the deadline/throughput trade-off lives.

    ``level`` / ``weight_bytes`` / ``flops_fn`` normally come off a
    :class:`~repro_torch.core.paths.PathSpec` (``spec.roofline_for`` wraps
    this fn) so the model always matches what the path actually fuses —
    and, via the per-path FLOPs hook, its algorithmic class.
    """
    out = {}
    for b in buckets:
        m = H100Model.evaluate(
            H100DesignPoint(cfg=cfg, batch=int(b), chips=chips,
                           compute_bytes=compute_bytes), level,
            weight_bytes=weight_bytes, flops_fn=flops_fn)
        m["per_event_us"] = m["step_us"] / int(b)
        out[int(b)] = m
    return out


def path_bucket_policy(spec, cfg: JediNetConfig, params, *,
                       max_batch: int = 1024, compute_bytes: int = 2,
                       chips: int = 1, roofline: bool = True) -> dict:
    """One forward path's resolved serving policy + roofline, in one dict.

    The co-design view of the per-path bucket policy: the path's OWN
    shared-memory model (``spec.bucket_bytes``), the block's reservation
    before its first event (``spec.reserved_smem_bytes``), the ladder
    those produce, and the H100Model roofline per rung at the path's
    fusion level and weight precision.  ``params`` are RAW; the spec's
    transform hook (e.g. int8 quantization) is applied here so the
    reservation reflects the serving dtype.  The engine resolves the
    same ladder through ``spec.bucket_ladder`` at construction.
    ``roofline=False`` skips the per-rung H100Model evaluation for
    consumers that only render the ladder.
    """
    pparams = spec.prepare_params(params)
    ladder = spec.bucket_ladder(cfg, pparams, max_batch)
    out = {
        "path": spec.name,
        "compute_dtypes": tuple(spec.compute_dtypes),
        "weight_bytes": spec.weight_bytes,
        "per_sample_bytes": spec.bucket_bytes(cfg, pparams),
        "reserved_smem_bytes": spec.reserved_smem_bytes(cfg, pparams),
        "bucket_ladder": ladder,
    }
    if roofline:
        out["roofline"] = spec.roofline_for(cfg, ladder,
                                            compute_bytes=compute_bytes,
                                            chips=chips)
    return out


# ---------------------------------------------------------------------------
# Design-space exploration (Sec. 4.4).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Candidate:
    cfg: JediNetConfig
    n_fr: int
    r_fo: int
    fpga: dict
    gpu: dict                       # the reference's ``tpu``: H100 roofline
    accuracy: float | None = None   # filled in only for surviving candidates


def candidate_space(base: JediNetConfig,
                    fr_nl: Sequence[int] = (1, 2, 3, 4),
                    fr_size: Sequence[int] = (8, 16, 24, 32),
                    fo_first: Sequence[int] = (16, 32, 48, 64, 96),
                    n_fr_opts: Sequence[int] | None = None,
                    r_fo_opts: Sequence[int] = (1, 2, 4)):
    """Enumerate the paper's search space (Sec. 5.4.4).

    f_O / phi_O keep their layer count; only f_O's first hidden layer is
    re-sized, exactly as in the paper ("we keep the layer number and other
    configurations of f_O and phi_O the same to [5] but only set the size of
    their first layer").
    """
    if n_fr_opts is None:
        n_fr_opts = sorted({1, 2, 3, 4, 6, 8, 10, 13, 17, 25, 29,
                            base.n_objects - 1})
    for nl, s, fo1, n_fr, r_fo in itertools.product(
            fr_nl, fr_size, fo_first, n_fr_opts, r_fo_opts):
        fo_hidden = (fo1, *base.fo_hidden[1:])
        cfg = base.with_(fr_hidden=tuple([s] * nl), fo_hidden=fo_hidden)
        yield cfg, n_fr, r_fo


def explore(base: JediNetConfig,
            latency_budget_us: float = 1.0,
            alpha: float = 2.0,
            dsp_slack: float = 1.0,
            accuracy_proxy: Callable[[JediNetConfig], float] | None = None,
            max_candidates: int | None = None,
            fused_level: str = "full",
            **space_kw) -> dict:
    """Run the co-design DSE.

    1. enumerate candidates,
    2. evaluate the *analytic* FPGA latency + DSP models (cheap),
    3. prune: DSP > budget, or latency > alpha x budget (skip training),
    4. score survivors with `accuracy_proxy` (a trained-model eval in
       production; a capacity-based proxy in tests/benchmarks),
    5. return Opt-Latn (min latency, ties by accuracy) and Opt-Acc
       (max accuracy with latency <= budget).
    """
    survivors: list[Candidate] = []
    n_total = n_pruned_dsp = n_pruned_lat = 0
    for cfg, n_fr, r_fo in candidate_space(base, **space_kw):
        n_total += 1
        if max_candidates and n_total > max_candidates:
            break
        pt = FPGADesignPoint(cfg=cfg, n_fr=n_fr, r_fo=r_fo)
        fpga = FPGAModel.evaluate(pt)
        # eq. (1) is an upper bound: Vivado HLS shares DSPs across the fused
        # loop (Table 1 reports ~1.8-3x fewer DSPs than eq. 1 predicts for
        # J3..U5), so the budget check allows a calibrated slack factor.
        fpga["fits"] = fpga["dsp"] <= U250_DSPS * dsp_slack
        if not fpga["fits"]:
            n_pruned_dsp += 1
            continue
        if fpga["latency_us"] > alpha * latency_budget_us:
            n_pruned_lat += 1
            continue
        # model the best available kernel (the whole-network fusion) by
        # default; pass fused_level="edge"/"none" to study the others.
        gpu = H100Model.evaluate(H100DesignPoint(cfg=cfg), fused_level)
        survivors.append(Candidate(cfg=cfg, n_fr=n_fr, r_fo=r_fo,
                                   fpga=fpga, gpu=gpu))

    if accuracy_proxy is None:
        accuracy_proxy = capacity_accuracy_proxy
    for c in survivors:
        c.accuracy = accuracy_proxy(c.cfg)

    opt_latn = min(
        survivors, key=lambda c: (c.fpga["latency_us"], -c.accuracy),
        default=None)
    in_budget = [c for c in survivors if c.fpga["latency_us"] <= latency_budget_us]
    opt_acc = max(in_budget, key=lambda c: c.accuracy, default=None)
    return {
        "n_total": n_total,
        "n_pruned_dsp": n_pruned_dsp,
        "n_pruned_latency": n_pruned_lat,
        "n_survivors": len(survivors),
        "survivors": survivors,
        "opt_latn": opt_latn,
        "opt_acc": opt_acc,
        "training_runs_saved": n_pruned_dsp + n_pruned_lat,
    }


def capacity_accuracy_proxy(cfg: JediNetConfig) -> float:
    """Cheap monotone proxy for model accuracy used when no trained eval is
    plugged in: saturating log-capacity of the three MLPs.  The paper's
    observation (Sec 4.4) is that accuracy is far less sensitive to f_R's
    size than latency is — so the proxy weights f_O capacity higher.
    """
    from repro_torch.nn.core import mlp_dims
    cap_fr = sum(i * o for i, o in mlp_dims(2 * cfg.n_features,
                                            list(cfg.fr_hidden), cfg.d_e))
    cap_fo = sum(i * o for i, o in mlp_dims(cfg.n_features + cfg.d_e,
                                            list(cfg.fo_hidden), cfg.d_o))
    cap_phi = sum(i * o for i, o in mlp_dims(cfg.d_o, list(cfg.phi_hidden),
                                             cfg.n_targets))
    return 70.0 + 2.2 * math.log10(1 + cap_fr) + 3.0 * math.log10(1 + cap_fo) \
        + 0.8 * math.log10(1 + cap_phi)


# --- paper Table 2 reference points (for the fidelity benchmark) -----------

def paper_table2_points() -> list[dict]:
    """The J1..J5 / U1..U5 design points with published II / latency."""
    j30 = dict(n_objects=30, n_features=16, d_e=8, d_o=24)
    u50 = dict(n_objects=50, n_features=16, d_e=8, d_o=24)
    mk = lambda base, fr, fo, nfr, rfo: dict(
        cfg=JediNetConfig(**base, fr_hidden=fr, fo_hidden=fo, phi_hidden=fo),
        n_fr=nfr, r_fo=rfo)
    return [
        dict(name="J1", **mk(j30, (20,) * 3, (20,) * 3, 1, 1),
             paper_ii_cycles=880, paper_latency_cycles=2511),
        dict(name="J2", **mk(j30, (20,) * 3, (20,) * 3, 13, 1),
             paper_ii_cycles=80, paper_latency_cycles=382),
        dict(name="J3", **mk(j30, (8,) * 1, (48,) * 3, 10, 1),
             paper_ii_cycles=90, paper_latency_cycles=124),
        dict(name="J4", **mk(j30, (8,) * 1, (48,) * 3, 29, 1),
             paper_ii_cycles=30, paper_latency_cycles=58),
        dict(name="J5", **mk(j30, (32,) * 2, (48,) * 3, 6, 1),
             paper_ii_cycles=150, paper_latency_cycles=181),
        dict(name="U1", **mk(u50, (50,) * 3, (50,) * 3, 1, 1),
             paper_ii_cycles=2462, paper_latency_cycles=6519),
        dict(name="U2", **mk(u50, (50,) * 3, (50,) * 3, 3, 1),
             paper_ii_cycles=854, paper_latency_cycles=2493),
        dict(name="U3", **mk(u50, (50,) * 3, (50,) * 3, 4, 4),
             paper_ii_cycles=650, paper_latency_cycles=2131),
        dict(name="U4", **mk(u50, (8,) * 2, (32,) * 3, 25, 1),
             paper_ii_cycles=100, paper_latency_cycles=130),
        dict(name="U5", **mk(u50, (8,) * 2, (48,) * 3, 17, 1),
             paper_ii_cycles=150, paper_latency_cycles=181),
    ]
