"""moonlight-16b-a3b (DeepSeek-V3's architecture, port only): the
program's MLA model against the plain fp32 reference
``repro_torch.models.plain_deepseek_v3`` at ``tiny_config`` on the CPU
(d_model 64, 2 heads, kv_lora 32, nope / rope / v 16 / 8 / 16, 8 experts
top-2, 1 shared, 1 dense + 2 MoE layers, vocab 512, fp32), and the
published config against the catalog's values.  The init's RMSNorm scales
are ones; the tests draw them from 1 + N(0, 0.1), so that a scale the
program drops or applies to the wrong tensor misses the bar.

Bar: 1e-4 of max(1, max |reference logit|).  Both sides compute in
fp32 on the same weights and route the same way (the program's router
scores agree with the reference's to ~1e-7 and no top-k margin on these
inputs is that thin), so what is left is summation order (cuBLAS-free
CPU GEMMs of different shapes: the absorbed decode sums over the latent
where the naive form sums over the head width), ~1e-6, grown by three
layers and the head; a dropped shared expert or a missing routed scale
moves the logits by far more than the bar (test below).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.common.tree import path_map
from repro_torch.configs import registry
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import plain_deepseek_v3 as ref
from repro_torch.models import transformer as tfm
from repro_torch.serving.lm import LMEngine, tiny_config

TOL = 1e-4
ARCH = "moonlight-16b-a3b"

#: The catalog's row for Moonlight-16B-A3B: its config.json as published
#: (https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json).
CATALOG = {
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 11264,
    "kv_lora_rank": 512, "max_position_embeddings": 8192,
    "model_type": "deepseek_v3", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": True,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16,
    "num_nextn_predict_layers": 0, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05,
    "rope_theta": 50000, "routed_scaling_factor": 2.446,
    "scoring_func": "sigmoid", "seq_aux": True, "tie_word_embeddings": False,
    "topk_group": 1, "topk_method": "noaux_tc", "v_head_dim": 128,
    "vocab_size": 163840,
}


def ref_cfg(c) -> dict:
    """The reference's config dict (config.json keys) of an MLAConfig."""
    return {
        "hidden_size": c.d_model, "num_attention_heads": c.n_heads,
        "kv_lora_rank": c.kv_lora_rank, "qk_nope_head_dim": c.qk_nope_head_dim,
        "qk_rope_head_dim": c.qk_rope_head_dim, "v_head_dim": c.v_head_dim,
        "rms_norm_eps": c.norm_eps, "rope_theta": c.rope_theta,
        "first_k_dense_replace": c.first_k_dense,
        "num_hidden_layers": c.n_layers, "n_routed_experts": c.moe.n_experts,
        "num_experts_per_tok": c.moe.top_k,
        "n_shared_experts": c.moe.n_shared_experts,
        "norm_topk_prob": c.moe.norm_topk_prob,
        "routed_scaling_factor": c.moe.routed_scaling_factor,
        "vocab_size": c.vocab_size,
    }


def ref_weights(params, cfg):
    """The reference's (outer, layer) callables over the program's params,
    each tensor upcast to fp32."""
    def f(t):
        return t.float()

    def outer():
        return {"embed": f(params["embed"]["w"]),
                "final_norm": f(params["final_norm"]["scale"]),
                "lm_head": f(params["lm_head"]["w"])}

    def layer(i):
        lp, a = params["layers"], params["layers"]["attn"]
        lw = {"attn_norm": f(lp["attn_norm"]["scale"][i]),
              "ffn_norm": f(lp["ffn_norm"]["scale"][i]),
              "kv_norm": f(a["kv_norm"]["scale"][i]),
              **{n: f(a[n]["w"][i]) for n in ("wq", "wkv_a", "wkv_b", "wo")}}
        if i < cfg.first_k_dense:
            lw.update({n: f(params["dense"][n]["w"][i])
                       for n in ("w_gate", "w_in", "w_out")})
        else:
            m = params["moe"]
            j = i - cfg.first_k_dense
            lw.update({"router_w": f(m["router"]["w"][j]),
                       "router_bias": f(m["router"]["bias"][j])})
            lw.update({f"experts_{n}": f(m["experts"][n][j])
                       for n in ("w_gate", "w_in", "w_out")})
            lw.update({f"shared_{n}": f(m["shared"][n]["w"][j])
                       for n in ("w_gate", "w_in", "w_out")})
        return lw
    return outer, layer


def _cfg(**moe):
    c = tiny_config(registry.get_arch(ARCH).model)
    if moe:
        c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
    return c


def _rel(a, b):
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _toks(n, seed=0, v=512):
    return torch.from_numpy(
        np.random.RandomState(seed).randint(0, v, n).astype(np.int64))


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    params = tfm.init(3, cfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    path_map(lambda path, t: t.copy_(1 + 0.1 * torch.randn(
        t.shape, generator=gen)) if path.endswith("scale") else t, params)
    return cfg, params


def _reference(params, cfg, seqs, **kw):
    outer, layer = ref_weights(params, cfg)
    return ref.forward(outer, layer, ref_cfg(cfg), seqs, **kw)


@pytest.mark.parametrize("case", ["forward", "engine", "absorbed"])
def test_program_matches_the_plain_reference(tiny, case):
    """``forward`` over two sequences; prefill then 8 decode steps through
    ``LMEngine`` (two slots, prompts of 5 and 11, ladder-padded); and the
    absorbed decode over the latent cache against the naive form of the
    same sequence."""
    cfg, params = tiny
    if case == "forward":
        toks = torch.stack([_toks(12, 1), _toks(12, 2)])
        got = tfm.forward(params, cfg, toks)[0]
        want = _reference(params, cfg, list(toks))
        for g, w in zip(got, want):
            assert _rel(g, w) < TOL
        return
    if case == "absorbed":
        toks = _toks(14, 4)
        logits, _, cache = tfm.forward(params, cfg, toks[None, :6],
                                       return_cache=True)
        full = tfm.init_cache(cfg, 1, 32, device="cpu")
        for key in ("ckv", "kpe"):
            full[key][:, :, :6] = cache[key]
        full["slot_pos"][0, :6] = torch.arange(6)
        full["pos"][0] = 6
        naive = tfm.forward(params, cfg, toks[None])[0][0]
        for t in range(6, 14):
            step, full = tfm.decode_step(params, cfg, full, toks[t:t + 1])
            assert _rel(step[0], naive[t]) < TOL
        return
    eng = LMEngine(params, cfg, slots=2, max_seq=32, device="cpu")
    prompts = [_toks(5, 5).numpy(), _toks(11, 6).numpy()]
    reqs = [eng.submit(p, 9) for p in prompts]
    rows, more = [], True
    while more:
        more = eng.step()
        for s, r in eng.last_decoded:
            rows.append((r.rid, len(r.out) - 1, eng.last_logits[s].clone()))
    assert [len(r.out) for r in reqs] == [9, 9]
    assert len(rows) == 16
    for rid, n, got in rows:
        seq = torch.as_tensor(np.concatenate([prompts[rid], reqs[rid].out[:n]]))
        want = _reference(params, cfg, [seq], positions=[[-1]])[0][0]
        assert _rel(got, want) < TOL
        assert int(got.argmax()) == reqs[rid].out[n]


def test_decode_through_the_engine_keeps_the_latent_cache_in_place(tiny):
    cfg, params = tiny
    eng = LMEngine(params, cfg, slots=2, max_seq=32, device="cpu")
    assert eng.layer_keys == ("ckv", "kpe")
    assert tuple(eng.cache["ckv"].shape) == (3, 2, 32, 32)
    assert tuple(eng.cache["kpe"].shape) == (3, 2, 32, 8)
    eng.warm([16])
    assert not eng.cache["ckv"].any() and (eng.cache["slot_pos"] == -1).all()
    eng.submit(_toks(7, 8).numpy(), 3)
    eng.step()
    assert (eng.cache["slot_pos"][0, :8] == torch.arange(8)).all()
    assert eng.cache["ckv"][:, 0, :8].abs().sum(-1).gt(0).all()
    # positions attended by the one active slot: 7 + the new row
    assert eng.metrics.counter("lm.kv_positions") == 8


def test_router_scores_by_sigmoid_chooses_with_the_bias_and_scales():
    moe = _cfg().moe
    torch.manual_seed(0)
    x = torch.randn(5, 16)
    w = torch.randn(16, 8)
    bias = torch.zeros(8)
    bias[7] = 10.0                       # expert 7 always chosen
    weights, ids = moe_lib.routed_choice(
        {"router": {"w": w, "bias": bias}}, moe, x)
    s = torch.sigmoid(x @ w)
    assert (ids[:, 0] == 7).all()
    other = torch.sort(s[:, :7], dim=-1, descending=True, stable=True).indices
    assert (ids[:, 1] == other[:, 0]).all()
    chosen = s.gather(1, ids)
    want = chosen / chosen.sum(-1, keepdim=True) * moe.routed_scaling_factor
    torch.testing.assert_close(weights, want, rtol=1e-6, atol=0)
    assert torch.allclose(weights.sum(-1),
                          torch.full((5,), moe.routed_scaling_factor))
    # the bias picks, the unbiased score weighs: expert 7's weight is
    # its own sigmoid share, not one pushed up by +10
    assert (weights[:, 0] < moe.routed_scaling_factor).all()


def test_dropless_experts_lose_no_token_the_capacity_path_drops(tiny):
    """Every token routed to expert 0 (and its runner-up): the routed MoE
    matches the reference's loop over experts, while the capacity path
    of the same width keeps only its capacity's tokens there."""
    cfg, params = tiny
    lp = tfm._layer(params["moe"], 0)
    lp = {**lp, "router": {**lp["router"],
                           "bias": torch.tensor([50.0] + [0.0] * 7)}}
    x = torch.randn(40, cfg.d_model, generator=torch.Generator().manual_seed(0))
    route = torch.zeros((40, 2), dtype=torch.uint8)
    y = moe_lib.routed_moe_apply(lp, cfg.moe, x, compute_dtype=torch.float32,
                                 route=route)
    assert (route[:, 0] == 0).all()
    outer, layer = ref_weights(params, cfg)
    lw = {**layer(1), "router_bias": lp["router"]["bias"]}
    want = ref.moe(lw, ref_cfg(cfg), x)
    assert _rel(y, want) < TOL
    cap = MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25)
    assert moe_lib.capacity(40, cap) < 40
    slots = moe_lib.dispatch_slots(route.long(), cap,
                                   moe_lib.capacity(40, cap))
    assert int((slots == 8 * moe_lib.capacity(40, cap)).sum()) > 0


@pytest.mark.parametrize("change", [{"n_shared_experts": 0},
                                    {"routed_scaling_factor": 1.0}])
def test_a_changed_moe_misses_the_bar(tiny, change):
    cfg, params = tiny
    toks = _toks(12, 9)
    want = _reference(params, cfg, [toks])[0]
    got = tfm.forward(params, dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, **change)), toks[None])[0][0]
    assert _rel(got, want) > 100 * TOL


@pytest.mark.parametrize("norm", ["layers/attn_norm", "layers/ffn_norm",
                                  "layers/attn/kv_norm", "final_norm"])
def test_a_dropped_norm_scale_misses_the_bar(tiny, norm):
    cfg, params = tiny
    assert float((params["final_norm"]["scale"] - 1).abs().max()) > 0.05
    toks = _toks(12, 11)
    want = _reference(params, cfg, [toks])[0]
    got = tfm.forward(path_map(
        lambda path, t: torch.ones_like(t) if path == norm + "/scale" else t,
        params), cfg, toks[None])[0][0]
    assert _rel(got, want) > 100 * TOL


def test_published_config_matches_the_catalog():
    c = registry.get_arch(ARCH).model
    have = {
        "first_k_dense_replace": c.first_k_dense, "hidden_act": c.activation,
        "hidden_size": c.d_model, "intermediate_size": c.dense_d_ff,
        "kv_lora_rank": c.kv_lora_rank, "moe_intermediate_size": c.d_ff,
        "n_routed_experts": c.moe.n_experts,
        "n_shared_experts": c.moe.n_shared_experts,
        "norm_topk_prob": c.moe.norm_topk_prob,
        "num_attention_heads": c.n_heads,
        "num_experts_per_tok": c.moe.top_k, "num_hidden_layers": c.n_layers,
        "num_key_value_heads": c.n_kv_heads,
        "qk_nope_head_dim": c.qk_nope_head_dim,
        "qk_rope_head_dim": c.qk_rope_head_dim, "rms_norm_eps": c.norm_eps,
        "rope_theta": c.rope_theta,
        "routed_scaling_factor": c.moe.routed_scaling_factor,
        "tie_word_embeddings": c.tie_embeddings,
        "v_head_dim": c.v_head_dim, "vocab_size": c.vocab_size,
    }
    for key, value in have.items():
        assert value == CATALOG[key], key
    assert (c.param_dtype, c.compute_dtype) == ("bfloat16", "bfloat16")
    params = sum(int(np.prod(shape)) for shape, _, _ in tfm.mla_shapes(c).values())
    assert params == 15_960_110_208                       # 15.96 B
    cache = tfm.init_cache(c, 1, 1, device="meta")
    per_position = sum(cache[k].numel() * cache[k].element_size()
                       for k in ("ckv", "kpe"))
    assert per_position == 31_104


def test_registry_resolves_the_port_only_arch():
    spec = registry.get_arch(ARCH)
    assert spec.arch_id == ARCH and spec.family == "lm"
    assert ARCH not in registry.ARCH_MODULES
    assert ARCH in registry.PORT_ONLY_MODULES
    assert ARCH not in registry.ALL_ARCHS
    assert "moonshot-v1-16b-a3b" in registry.ARCH_MODULES


def test_serve_cli_serves_it_at_tiny_size(capsys):
    from repro_torch.launch.serve import main
    report = main(["--arch", ARCH, "--tiny", "--device", "cpu",
                   "--requests", "3", "--max-new", "4", "--slots", "2"])
    assert len(report["done"]) == 3
    assert all(len(r.out) == 4 for r in report["done"])
    assert "[serve] 3 requests" in capsys.readouterr().out


def test_route_record_keeps_every_choice_on_the_device(tiny):
    cfg, params = tiny
    rec = moe_lib.RouteRecord(2, 2, device="cpu", chunk_rows=20)
    eng = LMEngine(params, cfg, slots=2, max_seq=32, device="cpu",
                   route_record=rec)
    r = eng.submit(_toks(6, 10).numpy(), 3)
    while eng.step():
        pass
    pre = rec.rows(("prefill", r.rid))
    assert tuple(pre.shape) == (16, 2, 2)        # the padded rung's rows
    assert tuple(rec.rows(("decode", 0)).shape) == (2, 2, 2)
    seq = torch.as_tensor(np.concatenate([r.prompt, r.out[:2]]))
    routes = torch.cat([pre[:6], rec.rows(("decode", 0))[:1],
                        rec.rows(("decode", 1))[:1]])
    check = ref.RouteCheck(band=0.0)
    got = _reference(params, cfg, [seq], positions=[[-1]],
                     routes=[routes], check=check)[0][0]
    assert check.off_tie == 0 and check.choices == 8 * 2 * 2
    assert check.worst <= 0.0
    assert int(got.argmax()) == r.out[2]
