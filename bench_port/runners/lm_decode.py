"""Closed-loop LM decode through the port's ``LMEngine``: one scheduler
tick after another for the window, the queue never dry.

The system under test is ``repro_torch.serving.lm.LMEngine`` over the
registry's model (moonlight-16b-a3b: MLA over a latent cache, the
routed dropless MoE), with ``slots`` concurrent sequences over
``max_seq`` positions and the prompt ladder up to ``max_seq``.  Set-up
draws the weights from the seed on the card (``data/deepseek_v3_weights.py``:
the benchmark's own draw in the reference's layout, norm scales away from
1, handed to the program in its parameter tree), warms
every rung and the decode step, submits the requests of
``data/lm_tokens.py`` and runs the first tick, which prefills every slot
mid-flight; then ``warm_steps`` ticks.

* ``events_per_s``: an event is one emitted token; the tokens the
  window's ticks emitted (one per active slot a decode, one per
  admission) over the seconds from the first tick's start to the last
  tick's end.
* ``batch_p99_us``: the 99th percentile over every tick of the window
  (``LMEngine.step()``: its admissions' prefills and its decode, up to
  the tokens on the host).

The MoE keeps every expert choice on the card (a ``RouteRecord``, on from
set-up).  A reservoir of ``keep_rows`` (slot, step) decode logit rows,
drawn from the seed over the whole window, is kept on the card.  After
the window the program's cache is freed and the plain reference
(``reference/deepseek_v3.py``, fp32, TF32 off) runs each kept row's
whole sequence (prompt plus the tokens generated before that step) layer
by layer, each layer's bf16 weights cast to fp32 in turn, routing by the
served expert ids:

* ``logit_gap``: the widest |served - reference| over max(1, the
  largest reference logit) of the kept rows, limit the configuration's;
* ``token_off_tie``: of every token the server chose for a kept sequence
  (its prefill's first and each decode step's, up to the kept one: the
  head applied to the reference's hidden state at each), those whose
  reference logit lies more than twice the ``logit_gap`` limit (times
  max(1, the row's largest logit)) below the reference row's largest,
  which a served row within the limit cannot do; limit 0;
* ``cache_gap``: the latent cache where its precision acts, before any
  layer compounds rounding: every slot still serving at the window's end,
  its layer-:data:`CACHE_LAYER` ``ckv`` and ``kpe`` rows at every position
  it holds, read back and held against the reference's c_kv and k_pe
  there; the widest ||served - reference|| / ||reference|| over slots and
  the two tensors, limit the configuration's ``cache_gap_limit``;
* ``routing_off_tie``: served choices whose reference choice score
  (sigmoid + bias) lies more than the configuration's band below the
  reference's own sixth, limit 0;
* ``failed``: shed requests, non-finite kept rows and serving slots whose
  cache rows are not their positions in order, limit 0.

The reference draws the weights again from the seed after the program's
state is freed, so a served weight changed in place would show.

Controls (``lm_control.py``): ``fp8_weights`` serves every weight matrix
rounded through float8 e4m3 (a scale per matrix), the precision below the
configuration's bfloat16; ``fp8_cache`` keeps the latent cache in float8
e4m3; ``no_shared`` serves without the shared experts; ``scale1`` with a
routed scale of 1.
"""

from __future__ import annotations

import dataclasses
import random
import time

import numpy as np
import torch

from bench_port import lm_trace, trigger
from bench_port.data import deepseek_v3_weights as weights
from bench_port.data import lm_tokens
from bench_port.harness import family_module
from bench_port.judge import GapMeter

CONTROLS = ("fp8_weights", "fp8_cache", "no_shared", "scale1")

#: The layer whose latent-cache rows ``cache_gap`` reads: the first, where
#: only the roundings of its own projection and norm lie between the
#: embedding and the stored row.
CACHE_LAYER = 0

#: Rows of the reference's head computed at once (671 MB of fp32 logits
#: at 163,840 tokens).
HEAD_ROWS = 1024

#: config.json key -> the program's config attribute (``moe.`` for its MoE).
KEYS = {
    "first_k_dense_replace": "first_k_dense", "hidden_act": "activation",
    "hidden_size": "d_model", "intermediate_size": "dense_d_ff",
    "kv_lora_rank": "kv_lora_rank", "moe_intermediate_size": "d_ff",
    "n_routed_experts": "moe.n_experts",
    "n_shared_experts": "moe.n_shared_experts",
    "norm_topk_prob": "moe.norm_topk_prob",
    "num_attention_heads": "n_heads", "num_experts_per_tok": "moe.top_k",
    "num_hidden_layers": "n_layers", "num_key_value_heads": "n_kv_heads",
    "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "rms_norm_eps": "norm_eps",
    "rope_theta": "rope_theta",
    "routed_scaling_factor": "moe.routed_scaling_factor",
    "tie_word_embeddings": "tie_embeddings", "v_head_dim": "v_head_dim",
    "vocab_size": "vocab_size", "compute_dtype": "compute_dtype",
}


def model_config(config: dict):
    """The registry's model for ``config``, every key of :data:`KEYS`
    checked against the configuration's file."""
    from repro_torch.configs.registry import get_arch
    model = get_arch(config["arch_id"]).model
    for key, attr in KEYS.items():
        have = model
        for part in attr.split("."):
            have = getattr(have, part)
        if have != config[key]:
            raise ValueError(f"{config['name']}: {key} is {config[key]!r} in "
                             f"the benchmark's file but {have!r} in the "
                             "program's registry")
    return model


def served_config(model, control: str | None):
    if control == "no_shared":
        return dataclasses.replace(model, moe=dataclasses.replace(
            model.moe, n_shared_experts=0))
    if control == "scale1":
        return dataclasses.replace(model, moe=dataclasses.replace(
            model.moe, routed_scaling_factor=1.0))
    if control not in (None, "fp8_weights", "fp8_cache"):
        raise ValueError(f"control {control!r} is not one of {CONTROLS}")
    return model


def round_fp8(params) -> None:
    """Every weight matrix of ``params`` (the embedding and the head too)
    rounded in place through float8 e4m3 with a scale per matrix (its
    largest magnitude to 448)."""
    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif node.dim() >= 2:
            for m in node.view(-1, *node.shape[-2:]):
                scale = m.abs().amax().float().clamp_min(1e-30) / 448.0
                q = (m.float() / scale).to(torch.float8_e4m3fn)
                m.copy_(q.float() * scale)
    walk(params)


class Reservoir:
    """At most ``cap`` of the rows offered, each as likely as any other
    (reservoir sampling), drawn from ``seed``; a row is copied on the
    card only when it is kept."""

    def __init__(self, seed: int, cap: int):
        self.rng = random.Random(seed)
        self.cap = cap
        self.kept: list = []
        self.offered = 0

    def offer(self, make) -> None:
        if len(self.kept) < self.cap:
            self.kept.append(make())
        else:
            j = self.rng.randrange(self.offered + 1)
            if j < self.cap:
                self.kept[j] = make()
        self.offered += 1


@dataclasses.dataclass
class Kept:
    rid: int
    slot: int
    step: int            # the engine's decode step that made the row
    n_out: int           # tokens generated before that step
    logits: torch.Tensor


def tick(engine, state: dict, tracer, keep: Reservoir | None):
    """One ``engine.step()``; returns its seconds.  Notes each request's
    slot and first decode step, offers the step's rows to ``keep`` and,
    while tracing, counts what the slice did."""
    head = engine.queue[:engine.slots]
    prefills = engine.metrics.counter("prefills")
    positions = engine.metrics.counter("lm.kv_positions")
    steps = engine.decode_count
    t0 = time.perf_counter()
    engine.step()
    dt = time.perf_counter() - t0
    admitted = head[:engine.metrics.counter("prefills") - prefills]
    decoded = engine.decode_count > steps
    if decoded:
        step = engine.decode_count - 1
        for slot, req in engine.last_decoded:
            state["first"].setdefault(req.rid, step)
            if keep is not None:
                keep.offer(lambda s=slot, r=req: Kept(
                    r.rid, s, step, len(r.out) - 1,
                    engine.last_logits[s].clone()))
    state["tokens"] += len(admitted) + (len(engine.last_decoded)
                                        if decoded else 0)
    if tracer.active:
        c = tracer.counts
        c["ticks"] += 1
        c["decode_steps"] += int(decoded)
        c["decode_tokens"] += len(engine.last_decoded) if decoded else 0
        c["kv_positions"] += engine.metrics.counter("lm.kv_positions") \
            - positions
        c["admits"] += len(admitted)
        for req in admitted:
            c["prefill_tokens"] += len(req.prompt)
            c["prefill_ops"] += state["prefill_ops"](len(req.prompt))
        c["tokens"] = c["decode_tokens"] + c["admits"]
    return dt


def routes_of(engine, kept: Kept, state: dict) -> torch.Tensor:
    """The served expert ids of the kept row's whole sequence: its
    prefill's rows, then one row a decode step up to the kept one."""
    rec = engine.route_record
    req = state["requests"][kept.rid]
    pre = rec.rows(("prefill", kept.rid))[:len(req.prompt)]
    steps = [rec.rows(("decode", d))[kept.slot]
             for d in range(state["first"][kept.rid], kept.step + 1)]
    return torch.cat([pre, torch.stack(steps)]).long()


def live_rows(engine) -> list:
    """(tokens written, (ckv, kpe) rows) of every slot still serving, at
    layer :data:`CACHE_LAYER`, copied on the card; the rows are None where
    the slot's cache positions are not 0 .. n - 1 in order."""
    pos = engine.cache["pos"].cpu().tolist()
    out = []
    for s, req in enumerate(engine.slot_req):
        if req is None:
            continue
        n = pos[s]
        sp = engine.cache["slot_pos"][s, :n]
        toks = np.concatenate([req.prompt, np.asarray(req.out, np.int32)])
        rows = None
        if len(toks) >= n and bool((sp == torch.arange(
                n, dtype=sp.dtype, device=sp.device)).all()):
            rows = tuple(engine.cache[key][CACHE_LAYER, s, :n].clone()
                         for key in ("ckv", "kpe"))
        out.append((toks[:n], rows))
    return out


def run(run):
    from bench_port.harness import Outcome
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving.lm import LMEngine
    mix, config = run.cell.mix, run.cell.config
    run.tracer = lm_trace.LMTracer(run.tracer.enabled, run.device)
    model = model_config(config)
    cfg = served_config(model, run.control)
    work = family_module("work", config["family"])
    params = weights.program_params(
        weights.draw(config, run.seed, run.device), config)
    if run.control == "fp8_weights":
        round_fp8(params)
    rec = moe_lib.RouteRecord(model.n_moe_layers, model.moe.top_k,
                              device=run.device)
    slots, max_seq = int(mix["slots"]), int(mix["max_seq"])
    engine = LMEngine(params, cfg, slots=slots, max_seq=max_seq,
                      device=run.device, route_record=rec,
                      cache_dtype=(torch.float8_e4m3fn
                                   if run.control == "fp8_cache" else None))
    params = None
    engine.warm()
    state = {"first": {}, "tokens": 0, "requests": {},
             "prefill_ops": lambda n: work.prefill_ops(config, n)}
    for toks, max_new, _ in lm_tokens.requests(mix, run.seed,
                                               model.vocab_size):
        req = engine.submit(toks, max_new)
        state["requests"][req.rid] = req
    for _ in range(1 + int(mix["warm_steps"])):
        tick(engine, state, run.tracer, None)
    run.tracer.warm()
    before = engine.metrics.counters
    keep = Reservoir(run.seed, int(mix["keep_rows"]))
    state["tokens"] = 0
    ticks = []
    run.window_opens()
    if run.trace:
        a, b = run.trace_slice()
        run.tracer.arm(run.t_window + a, run.t_window + b)
    t_first = time.perf_counter()
    until = run.t_window + run.seconds
    while time.perf_counter() < until:
        run.tracer.tick(time.perf_counter())
        ticks.append(tick(engine, state, run.tracer, keep))
        if not engine.queue:
            raise RuntimeError("the request queue ran dry in the window")
    window_s = time.perf_counter() - t_first
    run.tracer.finish()
    memory = trigger.memory_peak(run.device)
    counters = trigger.delta(before, engine.metrics.counters)
    tokens = state["tokens"]
    lat_us = np.asarray(ticks) * 1e6
    run.log(f"window {window_s:.3f} s: {len(ticks)} ticks, {tokens} tokens, "
            f"{counters.get('prefills', 0)} admissions; tick p50 "
            f"{np.percentile(lat_us, 50):.1f} us, p99 "
            f"{np.percentile(lat_us, 99):.1f} us; route record "
            f"{rec.nbytes} B; kept rows {[(k.rid, k.step) for k in keep.kept]}"
            f"; counters {counters}")
    live = live_rows(engine)
    failed = counters.get("lm_shed_requests", 0) + sum(
        not bool(torch.isfinite(k.logits).all()) for k in keep.kept) + sum(
        rows is None for _, rows in live)
    got = judge(run, engine, keep.kept, state, live)
    return Outcome(
        attempted=tokens, failed=failed,
        metrics={"events_per_s": tokens / window_s,
                 "batch_p99_us": float(np.percentile(lat_us, 99))},
        checks={"logit_gap": (got["logit_gap"],
                              float(config["logit_gap_limit"])),
                "token_off_tie": (got["token_off_tie"], 0),
                "cache_gap": (got["cache_gap"],
                              float(config["cache_gap_limit"])),
                "routing_off_tie": (got["routing_off_tie"], 0),
                "failed": (failed, 0)},
        memory_peak_bytes=memory, counters=counters, window_events=tokens)


def release(engine) -> None:
    """Drop the program's cache, weights and callables."""
    engine.cache = engine.last_logits = None
    engine.workload.params = engine.workload._compute_params = None
    engine._cache.clear()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
        torch.cuda.empty_cache()


def judge(run, engine, kept, state, live) -> dict:
    """The kept rows and the live slots' latent cache against the
    reference (see the module docstring), after the program's state is
    freed and the weights drawn again."""
    ref = family_module("reference", run.cell.config["family"])
    config, dev = run.cell.config, run.device
    q_block = int(run.cell.mix["ref_q_block"])
    seqs, routes, positions, served = [], [], [], []
    for k in kept:
        req = state["requests"][k.rid]
        full = np.concatenate([req.prompt, np.asarray(req.out, np.int32)])
        n, p = len(req.prompt) + k.n_out, len(req.prompt)
        seqs.append(torch.as_tensor(full[:n], device=dev))
        positions.append(list(range(p - 1, n)))
        served.append(torch.as_tensor(full[p:n + 1], device=dev).long())
        routes.append(routes_of(engine, k, state))
    release(engine)
    w = weights.draw(config, run.seed, dev)
    outer, layer = weights.reference_weights(w, config)
    have = [(toks, rows) for toks, rows in live if rows is not None]
    want = ref.latent(outer, layer, config,
                      [torch.as_tensor(t, device=dev) for t, _ in have],
                      CACHE_LAYER, q_block=q_block)
    cache = {"ckv": 0.0, "kpe": 0.0}
    for (_, rows), pair in zip(have, want):
        for key, got, exp in zip(cache, rows, pair):
            rel = float((got.float() - exp).norm() / exp.norm())
            cache[key] = max(cache[key], rel if rel == rel else float("inf"))
    want = None
    check = ref.RouteCheck(band=float(config["route_tie_band"]))
    hidden = ref.forward(outer, layer, config, seqs, positions=positions,
                         routes=routes, check=check, q_block=q_block,
                         head=False)
    head = {"lm_head": w["lm_head"].float()}
    band = 2 * float(config["logit_gap_limit"])
    meter, off, worst, tokens = GapMeter(), 0, 0.0, 0
    for k, h, nxt in zip(kept, hidden, served):
        for i in range(0, len(h), HEAD_ROWS):
            z = ref.head(head, h[i:i + HEAD_ROWS])
            t = nxt[i:i + HEAD_ROWS]
            short = (z.amax(-1) - z.gather(1, t[:, None])[:, 0]) \
                / z.abs().amax(-1).clamp_min(1.0)
            off += int((short > band).sum())
            worst = max(worst, float(short.max()))
            tokens += len(t)
        meter.add(k.logits.float().cpu().numpy()[None],
                  z[-1:].cpu().numpy())
    run.log(f"compared {len(kept)} decode rows (sequences of "
            f"{[len(s) for s in seqs]} tokens) against the reference: widest "
            f"gap {meter.gap:.6e} of scale {meter.scale:.4f}; tokens: "
            f"{off} of {tokens} served tokens off the band {band}, widest "
            f"shortfall {worst:.6e}; routing: {check.off_tie} of "
            f"{check.choices} served choices off the tie band {check.band}, "
            f"widest shortfall {check.worst:.6e}; latent cache at layer "
            f"{CACHE_LAYER} over {len(have)} serving slots: widest relative "
            f"ckv {cache['ckv']:.6e}, kpe {cache['kpe']:.6e}")
    return {"logit_gap": meter.gap if meter.events else float("inf"),
            "token_off_tie": off, "routing_off_tie": check.off_tie,
            "cache_gap": max(cache.values()) if have else float("inf")}
