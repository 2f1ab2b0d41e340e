"""LM continuous batching on the serving fabric: prefill + slot decode.

Port of ``repro.serving.lm``.  The slot-recycling decode loop rides the
port's :class:`~repro_torch.serving.core.ExecutionCore`, as the trigger
engine does:

* **bucketed prefill** — prompts are right-padded up a power-of-two
  length ladder, so mixed-length requests share one bound callable per
  rung.  With causal attention the pad positions cannot influence
  positions before them, so the spliced ``[:pl]`` cache slice and the
  ``pl - 1`` logits row are exactly what the unpadded prefill gives.
* **bound-callable cache + fault seams** — prefill and decode callables
  live in the core's cache under ``("lm", L)`` / ``("lm", "decode")``
  keys; a :class:`~repro_torch.serving.faults.FaultInjector` can target
  the compile and dispatch seams by ``path="lm"``.  Every callable steps
  on one copy of the weights cast to the compute dtype
  (:meth:`LMWorkload.compute_params`, made at the first build).
* **metrics, deadlines, health** — decode steps land in the shared
  :class:`~repro_torch.serving.metrics.ServingMetrics`, queued requests
  carry serve-by deadlines that shed instead of admitting late, and
  ``health()`` reports ``healthy`` / ``shedding`` plus slot gauges.

Scheduling is the reference's: admit free slots FIFO in slot order
before each decode step, one token per active slot per step, retire at
``max_new`` and recycle the slot.  On the card each decode step runs
kernel B5 once per layer (``models/transformer.py``); nothing here is a
CUDA graph or ``torch.compile``: every callable launches eagerly.

An MoE LM (moonshot-v1-16b-a3b) serves through the same engine.  Its
expert capacity comes from the token count of each call: a decode step
routes the ``slots`` tokens (capacity 8 at 16 slots), a prefill the
padded rung's tokens, pad tokens included, which compete for expert
slots after the real ones, as in the reference.  So for an MoE the
spliced prefill is the padded one, not what an unpadded prefill would
give; the port pads exactly as the reference does.

An MLA LM (moonlight-16b-a3b, port only) serves through the same engine:
its cache holds ``ckv`` / ``kpe`` in place of ``k`` / ``v`` (the engine
splices and restores whatever per-layer keys the cache has), and its
routed MoE is dropless, so its padded prefill gives each real token what
the unpadded one would.  Its expert choices can be kept on the card by a
:class:`~repro_torch.models.moe.RouteRecord` (``route_record=``).

Spans (``ServingMetrics.span``, live only while a profiler records):
``lm.admit`` (a request's prefill, splice and first token) and
``lm.decode`` (a tick's decode step up to its tokens on the host).  The
counter ``lm.kv_positions`` adds, for every decode step, the cache
positions each active slot attends over (its length after this step's
row, at most the cache's), from the host's own count.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import MLAConfig
from repro_torch.models import transformer as tfm
from repro_torch.serving.core import ExecutionCore, Workload, to_device
from repro_torch.serving.engine import params_to
from repro_torch.serving.metrics import ServingMetrics


@dataclasses.dataclass
class LMRequest:
    """One generation request: prompt in, greedy continuation out."""
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    t_deadline: float | None = None     # absolute admit-by time (clock base)
    shed: bool = False


def prompt_bucket_ladder(max_len: int, *, start: int = 16) -> list[int]:
    """Power-of-two prompt-length ladder up to (and capped at) ``max_len``:
    any prompt length pads up to the next rung, so L distinct lengths cost
    O(log L) prefill builds instead of L."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    ladder, b = [], max(1, start)
    while b < max_len:
        ladder.append(b)
        b *= 2
    ladder.append(max_len)
    return ladder


class LMWorkload(Workload):
    """Transformer prefill/decode as a fabric :class:`Workload`.

    Buckets are PROMPT LENGTHS (ints) for prefill, plus ``"decode"`` for
    the slot-batched decode step — both flow through
    :meth:`~repro_torch.serving.core.ExecutionCore.compiled_for`'s cache
    and compile fault seam under ``path="lm"``.
    """

    name = "lm"

    def __init__(self, params, cfg, *, slots: int, max_seq: int,
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.slots = int(slots)
        self.max_seq = int(max_seq)
        self._compute_params = None

    def compute_params(self):
        """The weights cast to the compute dtype, made once and shared by
        every bucket's callable (one cast per rung would hold a copy per
        rung)."""
        if self._compute_params is None:
            self._compute_params = tfm.compute_params(self.params, self.cfg)
        return self._compute_params

    def bucket_ladder(self, max_batch: int) -> list[int]:
        # ``max_batch`` is the longest admissible prompt here
        return prompt_bucket_ladder(min(max_batch, self.max_seq))

    def cache_key(self, bucket) -> tuple:
        c = self.cfg
        return (self.name, bucket, c.n_layers, c.d_model, c.n_heads,
                c.n_kv_heads, c.vocab_size, c.compute_dtype)

    def build(self, bucket):
        """The bucket's callable, run inside :func:`tfm.xla_rounding`: the
        LM's owner sets the process-wide cuBLAS rounding flags around its
        own calls and restores them after.  Keyword arguments (an MLA
        model's ``route=``) pass through to the model."""
        params = self.compute_params()
        if bucket == "decode":             # (cache, tokens) -> (logits, cache)
            fn = functools.partial(tfm.decode_step, params, self.cfg)
        else:  # prefill at the padded length: tokens -> (logits, aux, cache)
            fn = functools.partial(tfm.forward, params, self.cfg,
                                   return_cache=True)

        def run(*args, **kw):
            with tfm.xla_rounding():
                return fn(*args, **kw)
        return run

    def placeholder(self, bucket: int) -> np.ndarray:
        return np.zeros((1, int(bucket)), np.int32)


class LMEngine(ExecutionCore):
    """Slot-recycling continuous-batching LM server on the fabric.

    ``submit()`` enqueues requests; ``step()`` is one scheduler tick
    (admit free slots, one batched decode step); ``run()`` drains to
    completion.  The decode cache is batched over ``slots`` concurrent
    requests on ``device`` (the card by default; raises without one); a
    finished request releases its slot to the next queued one mid-stream.

    ``cache_dtype`` overrides the cache's dtype (the compute dtype by
    default).  ``route_record`` (an MLA model's
    :class:`~repro_torch.models.moe.RouteRecord`) keeps the experts each
    prefill (tag ``("prefill", rid)``, the padded rung's rows) and each
    decode step (tag ``("decode", n)``, a row per slot) chose.  After a
    decode step ``last_logits`` holds its (slots, V) fp32 logits and
    ``last_decoded`` the (slot, request) pairs it served.
    """

    def __init__(self, params, cfg, *, slots: int = 4, max_seq: int = 128,
                 prompt_buckets=None, metrics: ServingMetrics | None = None,
                 injector=None, clock=time.monotonic, device="cuda",
                 cache_dtype=None, route_record=None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        super().__init__(
            LMWorkload(params, cfg, slots=slots, max_seq=max_seq,
                       device=device),
            bucket_sizes=prompt_buckets, max_batch=max_seq,
            metrics=metrics, injector=injector)
        self._clock = clock
        self.slots = int(slots)
        self.max_seq = int(max_seq)
        self.cache = tfm.init_cache(cfg, slots, max_seq, dtype=cache_dtype,
                                    device=self.device)
        #: the cache's per-layer tensors (k / v, or an MLA model's ckv / kpe)
        self.layer_keys = tuple(k for k in self.cache
                                if k not in ("slot_pos", "pos"))
        self.route_record = route_record
        self.last_logits: torch.Tensor | None = None
        self.last_decoded: list[tuple[int, LMRequest]] = []
        self.decode_count = 0
        # each slot's next cache position, known on the host
        self._next_pos = [0] * slots
        self.slot_req: list[LMRequest | None] = [None] * slots
        self.queue: list[LMRequest] = []
        self.done: list[LMRequest] = []
        self._next_rid = 0
        #: each decode step's seconds (host clock, to the tokens read),
        #: apart from the prefills that share the metrics' batch records
        self.decode_s: list[float] = []
        self._last_shed: float | None = None
        self.shed_window_s = 5.0

    # -- request flow -------------------------------------------------------

    def submit(self, prompt, max_new: int, *,
               deadline_s: float | None = None) -> LMRequest:
        """Enqueue one request; it admits when a slot frees up.  With a
        ``deadline_s`` budget the request is SHED (never admitted,
        ``shed=True``, empty ``out``) if it is still queued past it."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("empty prompt")
        if prompt.shape[0] > self.max_seq:
            raise ValueError(
                f"prompt length {prompt.shape[0]} exceeds max_seq "
                f"{self.max_seq}")
        req = LMRequest(self._next_rid, prompt, int(max_new))
        if deadline_s is not None:
            req.t_deadline = self._clock() + deadline_s
        self._next_rid += 1
        self.queue.append(req)
        self.metrics.incr("lm_requests")
        self._update_gauges()
        return req

    def warm(self, buckets=None) -> None:
        """Build (and run once) the prefill ladder AND the decode step,
        leaving the live cache as it was.  The reference decodes against a
        throwaway cache; the port's decode writes its cache in place, one
        row per slot and layer, so it decodes on the live cache and puts
        back what that step wrote (a throwaway cache would double the
        cache's memory: 12.9 GB at moonshot-v1-16b-a3b's 16 x 2,048)."""
        for b in buckets if buckets is not None else self.bucket_sizes:
            self.compiled_for(b)(
                to_device(self.workload.placeholder(b), self.device))
        cache = self.cache
        rows = (torch.arange(self.slots, device=self.device),
                (cache["pos"] % cache["slot_pos"].shape[1]).long())
        saved = {key: cache[key][:, rows[0], rows[1]].clone()
                 for key in self.layer_keys}
        slot_pos, pos = cache["slot_pos"].clone(), cache["pos"]
        toks = torch.zeros((self.slots,), dtype=torch.int32,
                           device=self.device)
        self.compiled_for("decode")(cache, toks)
        for key, rows_before in saved.items():
            cache[key][:, rows[0], rows[1]] = rows_before
        cache["slot_pos"].copy_(slot_pos)
        cache["pos"] = pos
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> bool:
        """One scheduler tick: admit free slots from the queue (shedding
        expired requests), then one batched decode step.  Returns True
        while work remains."""
        now = self._clock()
        for s in range(self.slots):
            if self.slot_req[s] is not None:
                continue
            while self.queue:
                req = self.queue.pop(0)
                if req.t_deadline is not None and now >= req.t_deadline:
                    self._shed(req)
                    continue
                self._admit(s, req)
                break
        if not any(r is not None for r in self.slot_req):
            self._update_gauges()
            return bool(self.queue)
        if self.injector is not None:
            self.injector.check("dispatch", path=self.workload.name,
                                bucket="decode")
        toks = torch.tensor([
            (self.slot_req[s].out[-1] if self.slot_req[s] else 0)
            for s in range(self.slots)], dtype=torch.int32,
            device=self.device)
        decode = self.compiled_for("decode")
        kw = {}
        if self.route_record is not None:
            kw["route"] = self.route_record.take(
                self.slots, ("decode", self.decode_count))
        self.last_decoded = [(s, r) for s, r in enumerate(self.slot_req)
                             if r is not None]
        positions, t = 0, self.cache["slot_pos"].shape[1]
        for s, _ in self.last_decoded:
            positions += min(self._next_pos[s] + 1, t)   # a rolling cache
            self._next_pos[s] += 1
        t0 = time.perf_counter()
        with self.metrics.span("lm.decode"):
            logits, self.cache = decode(self.cache, toks, **kw)
            nxt = torch.argmax(logits, -1).cpu().numpy()  # waits for the step
        t1 = time.perf_counter()
        self.last_logits = logits
        self.decode_count += 1
        active = len(self.last_decoded)
        self.metrics.record_batch(t1 - t0, active, self.slots)
        self._record_wall_window(t0, t1, active)
        self.decode_s.append(t1 - t0)
        self.metrics.incr("decode_steps")
        self.metrics.incr("tokens_emitted", active)
        self.metrics.incr("lm.kv_positions", positions)
        for s in range(self.slots):
            req = self.slot_req[s]
            if req is None:
                continue
            req.out.append(int(nxt[s]))
            if len(req.out) >= req.max_new:
                self.done.append(req)
                self.slot_req[s] = None           # release slot
        self._update_gauges()
        return bool(self.queue or any(r is not None for r in self.slot_req))

    def run(self) -> dict:
        """Drain the queue to completion; returns the serve report (the
        port adds ``decode_step_s``, this drain's decode-step seconds)."""
        n0 = len(self.decode_s)
        t0 = time.perf_counter()
        while self.step():
            pass
        dt = time.perf_counter() - t0
        steps = self.metrics.counter("decode_steps")
        return {
            "done": sorted(self.done, key=lambda r: r.rid),
            "steps": steps,
            "decode_step_s": self.decode_s[n0:],
            "wall_s": dt,
            "steps_per_s": steps / dt if dt > 0 else float("nan"),
            "shed": self.metrics.counter("lm_shed_requests"),
            "prefill_compiles": sum(
                1 for k in self._cache if k[1] != "decode"),
            "snapshot": self.metrics.snapshot(),
        }

    # -- internals ----------------------------------------------------------

    def _admit(self, slot: int, req: LMRequest) -> None:
        """Prefill one request (padded up the prompt ladder) and splice
        its ``[:pl]`` cache slice into the batch slot."""
        with self.metrics.span("lm.admit"):
            self._prefill_into(slot, req)

    def _prefill_into(self, slot: int, req: LMRequest) -> None:
        pl = int(req.prompt.shape[0])
        bucket = self.bucket_for(pl)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :pl] = req.prompt
        prefill = self.compiled_for(bucket)
        kw = {}
        if self.route_record is not None:
            kw["route"] = self.route_record.take(bucket, ("prefill", req.rid))
        t0 = time.perf_counter()
        logits, _, pc = prefill(to_device(toks, self.device), **kw)
        # causal attention: positions < pl never see the pad tail, so
        # this slice and the pl-1 logits row match the unpadded prefill.
        # The reference splices through a zeroed copy of the slot; the
        # port zeroes the slot and writes the prompt's rows in place.  As
        # in the reference, a prompt longer than the rolling SWA cache
        # (T = window < pl <= max_seq) does not fit the slot and raises.
        t = self.cache["slot_pos"].shape[1]
        for key in self.layer_keys:
            dst = self.cache[key][:, slot]
            dst.zero_()
            dst[:, :pl] = pc[key][:, 0, :pl]
        sp = torch.full((t,), -1, dtype=torch.int32, device=self.device)
        sp[:pl] = torch.arange(pl, dtype=torch.int32, device=self.device)
        self.cache["slot_pos"][slot] = sp
        self.cache["pos"][slot] = pl
        self._next_pos[slot] = pl
        first = int(torch.argmax(logits[0, pl - 1]))
        t1 = time.perf_counter()
        self.metrics.record_batch(t1 - t0, 1, bucket)
        self._record_wall_window(t0, t1, 1)
        self.metrics.incr("prefills")
        self.metrics.incr("tokens_emitted")
        req.out.append(first)
        self.slot_req[slot] = req

    def _shed(self, req: LMRequest) -> None:
        req.shed = True
        self.done.append(req)
        self.metrics.incr("lm_shed_requests")
        self._last_shed = self._clock()

    def _update_gauges(self) -> None:
        self.metrics.gauge("queue_depth", len(self.queue))
        self.metrics.gauge(
            "free_slots", sum(1 for r in self.slot_req if r is None))

    # -- health -------------------------------------------------------------

    def health(self) -> dict:
        """Same vocabulary as the trigger tier's health report: a state
        plus the counters/gauges it was derived from."""
        now = self._clock()
        shedding = (self._last_shed is not None
                    and now - self._last_shed < self.shed_window_s)
        return {
            "state": "shedding" if shedding else "healthy",
            "slots": self.slots,
            "free_slots": sum(1 for r in self.slot_req if r is None),
            "queue_depth": len(self.queue),
            "counters": self.metrics.counters,
            "gauges": self.metrics.gauges,
        }


# -- CLI driver (the thin repro_torch.launch.serve front-end calls this) -----


def tiny_config(cfg):
    """Shrink an arch config to a 2-layer miniature (same code path).  An
    MLA config keeps one dense and two MoE layers, with its latent and
    head widths, experts and dense width cut too."""
    if isinstance(cfg, MLAConfig):
        return dataclasses.replace(
            cfg, n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, d_ff=32,
            vocab_size=512, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, first_k_dense=1,
            dense_d_ff=128, param_dtype="float32", compute_dtype="float32",
            moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2,
                                    n_shared_experts=1))
    return dataclasses.replace(
        cfg, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, compute_dtype="float32", remat="none")


def build_lm_cli(ap) -> None:
    """Install the LM serve arguments on an ``argparse`` parser."""
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request admit-by budget; late requests shed")
    ap.add_argument("--health", action="store_true",
                    help="print the engine health report after the drain")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu (the "
                         "plain PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, drawn by torch on "
                         "--device")


def run_lm_cli(args) -> dict:
    """Serve ``--requests`` synthetic prompts through :class:`LMEngine`
    and print the reference's ``[serve]`` report."""
    from repro_torch.configs.registry import get_arch

    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise ValueError(f"{args.arch!r} is a {arch.family} arch; the serve "
                         "driver is for LM archs")
    cfg = tiny_config(arch.model) if args.tiny else arch.model
    # The weights are drawn in the compute dtype: the same values the
    # engine's one cast (``compute_params``) makes from fp32 draws, without
    # the fp32 copy (moonshot-v1-16b-a3b's would be 112 GB).
    cfg = dataclasses.replace(cfg, param_dtype=cfg.compute_dtype)
    dev = resolve_device(args.device)

    rng = np.random.RandomState(0)
    params = tfm.init(args.seed, cfg, device=dev)
    v = cfg.vocab_size

    engine = LMEngine(params, cfg, slots=args.slots, max_seq=args.max_seq,
                      device=dev)
    deadline_s = (args.deadline_ms * 1e-3
                  if args.deadline_ms is not None else None)
    for _ in range(args.requests):
        engine.submit(rng.randint(0, v, args.prompt_len), args.max_new,
                      deadline_s=deadline_s)
    report = engine.run()

    done = [r for r in report["done"] if not r.shed]
    print(f"[serve] {len(done)} requests, {report['steps']} decode steps, "
          f"{report['steps_per_s']:.1f} steps/s")
    print(f"[serve] prefill compiles: {report['prefill_compiles']}  "
          f"prompt buckets: {engine.bucket_sizes}  "
          f"shed: {report['shed']}")
    for r in done[:4]:
        print(f"  req {r.rid}: {r.out[:8]}...")
    if args.health:
        h = engine.health()
        print(f"[health] state={h['state']} free_slots={h['free_slots']} "
              f"queue_depth={h['queue_depth']}")
        for name in sorted(h["counters"]):
            print(f"  counter {name}={h['counters'][name]}")
    return report
