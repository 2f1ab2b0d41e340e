"""The port's dry run (``repro_torch.launch.dryrun``) on meshes of fake
ranks in this process.

``run_cell`` builds and runs one step of reduced cells of every family
(``tiny_config`` LMs with the batch of the production shape, so it
divides the mesh as the real one does; narrow GNNs; a small FM table;
JEDI-net at its own width) on the 16 x 16 mesh of a ``fake`` group of
256 ranks (one on the 2 x 16 x 16 mesh of 512), and each record has the
reference's keys with ``status: ok``.  Rank 0's counts are per rank:
JEDI-net's 1,024-event batch sharded 16 ways counts exactly the FLOPs of
an unsharded 64-event forward.  B5's fake kernel and FLOP formula match
``chip_smoke.decode_work``.  The CLI runs in a subprocess.  ``run_cell``
destroys its process group whatever happens.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import roofline as jroof
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.core import interaction_net as inet
from repro_torch.kernels.flash_decode import kernel as FDK
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import run_cell
from repro_torch.serving.lm import tiny_config

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: The reference's per-cell record keys (``repro.launch.dryrun.run_cell``
#: and ``roofline.from_compiled``).
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "status", "roofline",
               "collectives", "memory", "kind", "notes", "lower_s",
               "compile_s"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}


def _reduced(arch_id):
    arch = get_arch(arch_id)
    m = arch.model
    if arch.family == "lm":
        m = tiny_config(m)
        if m.moe is not None:       # experts divide the 16-way data axis
            m = dataclasses.replace(m, moe=dataclasses.replace(
                m.moe, n_experts=16, top_k=2))
    elif arch.family == "gnn":
        m = dataclasses.replace(m, n_layers=2, d_hidden=16)
    elif arch.family == "recsys":
        m = dataclasses.replace(m, vocab_sizes=(1024,) * m.n_sparse)
    return dataclasses.replace(arch, model=m)


CELLS = {
    "lm_train": ("h2o-danube-1.8b", ShapeSpec(
        "train_4k", "train", dict(seq_len=32, global_batch=256))),
    "lm_prefill": ("minicpm-2b", ShapeSpec(
        "prefill_32k", "prefill", dict(seq_len=32, global_batch=32))),
    "lm_decode": ("h2o-danube-1.8b", ShapeSpec(
        "decode_32k", "decode", dict(seq_len=64, global_batch=128))),
    "moe_decode": ("moonshot-v1-16b-a3b", ShapeSpec(
        "decode_32k", "decode", dict(seq_len=64, global_batch=128))),
    "gnn_full": ("pna", ShapeSpec(
        "full_graph_sm", "full_graph",
        dict(n_nodes=600, n_edges=2000, d_feat=8))),
    "gnn_minibatch": ("gcn-cora", ShapeSpec(
        "minibatch_lg", "minibatch",
        dict(n_nodes=1000, n_edges=4000, batch_nodes=16, fanout=(3, 2),
             d_feat=8))),
    "gnn_molecule": ("meshgraphnet", ShapeSpec(
        "molecule", "batched_graphs",
        dict(n_nodes=6, n_edges=10, batch=32, d_feat=8))),
    "fm_train": ("fm", ShapeSpec("train_batch", "recsys_train",
                                 dict(batch=512))),
    "fm_retrieval": ("fm", ShapeSpec("retrieval_cand", "retrieval",
                                     dict(batch=1, n_candidates=1000))),
    "jedi_train": ("jedinet-30p", ShapeSpec("train_jets", "jedi_train",
                                            dict(batch=512))),
}


def _check_record(rec, mesh_name, chips):
    assert rec["status"] == "ok", rec.get("traceback")
    assert RECORD_KEYS <= set(rec) and rec["mesh"] == mesh_name
    assert rec["chips"] == chips == rec["roofline"]["chips"]
    assert set(jroof.RooflineTerms(1.0, 1.0, 1.0, 1).to_dict()) <= set(
        rec["roofline"])
    assert set(jroof.collective_bytes("")) <= set(rec["collectives"])
    assert set(rec["collectives"]["bytes_by_op"]) == set(
        jroof._COLLECTIVE_OPS)
    assert set(rec["memory"]) == MEMORY_KEYS
    r = rec["roofline"]
    assert r["hbm_bytes_per_chip"] > 0 and r["step_s"] > 0
    assert r["step_s"] == max(r["compute_s"], r["memory_s"],
                              r["collective_s"])
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("cell", list(CELLS))
def test_reduced_cell_runs_on_the_16x16_fake_mesh(cell, tmp_path):
    arch_id, shape = CELLS[cell]
    rec = run_cell(_reduced(arch_id), shape, False, str(tmp_path))
    _check_record(rec, "pod_16x16", 256)
    saved = json.loads((tmp_path / "pod_16x16" /
                        f"{arch_id}__{shape.name}.json").read_text())
    assert saved["status"] == "ok" and saved["roofline"] == rec["roofline"]
    if rec["kind"] == "train":
        # sharded params: their grads cross the mesh
        assert rec["collectives"]["total_bytes"] > 0


def test_a_cell_runs_on_the_2x16x16_fake_mesh():
    arch_id, shape = CELLS["gnn_minibatch"]
    rec = run_cell(_reduced(arch_id), shape, True, "")
    _check_record(rec, "multipod_2x16x16", 512)


def test_jedi_infer_counts_rank_0s_share():
    """B=1,024 over the 16-way data axis: rank 0 runs the forward on 64
    events (params replicated, no collective), exactly the FLOPs of an
    unsharded 64-event forward."""
    arch = get_arch("jedinet-30p")
    rec = run_cell(arch, "stream_1k", False, "")
    _check_record(rec, "pod_16x16", 256)
    cfg = arch.model
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        p = inet.init(0, cfg, device="cpu")
        x = torch.empty(64, cfg.n_objects, cfg.n_features)
        c = roofline.StepCounter(mode)
        with c:
            inet.forward_sr_split(p, cfg, x, grid=False)
        with FlopCounterMode(display=False) as fc:
            inet.forward_sr_split(p, cfg, x, grid=False)
    assert rec["roofline"]["flops_by_dtype"] == {
        "float32": c.flops[torch.float32]}
    assert rec["roofline"]["flops_per_chip"] == fc.get_total_flops() > 0
    assert rec["collectives"]["total_count"] == 0


def _decode_work():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)   # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod.decode_work


@pytest.mark.parametrize("b,s,h,hkv,d,dtype", [
    (128, 4096, 32, 8, 80, torch.bfloat16), (3, 100, 4, 4, 64, torch.float32)])
def test_b5_fake_kernel_and_flop_formula(b, s, h, hkv, d, dtype):
    decode_work = _decode_work()
    mode = FakeTensorMode()
    with mode:
        q = torch.empty(b, hkv, h // hkv, d)
        k = torch.empty(b, s, hkv, d, dtype=dtype)
        v = torch.empty(b, s, hkv, d, dtype=dtype)
        q_pos = torch.empty(b, dtype=torch.int32)
        kv_pos = torch.empty(b, s, dtype=torch.int32)
        before = FDK.flash_decode_kernel_call.launches
        c = roofline.StepCounter(mode)
        with c, FlopCounterMode(display=False) as fc:
            out = FDK.flash_decode_kernel_call(q, k, v, q_pos, kv_pos,
                                               window=4096)
    assert tuple(out.shape) == (b, hkv, h // hkv, d)
    assert out.dtype == torch.float32
    assert FDK.flash_decode_kernel_call.launches == before
    ops = decode_work(b, s, h, hkv, d, k.element_size())[0]
    assert fc.get_total_flops() == ops == FDK.decode_flops(b, s, h, d)
    assert dict(c.flops) == {dtype: ops}


def test_a_failing_cell_is_recorded_and_its_group_destroyed():
    arch = get_arch("jedinet-30p")
    rec = run_cell(arch, ShapeSpec("odd", "no_such_kind", {}), False, "")
    assert rec["status"] == "error" and "no step builder" in rec["error"]
    assert not dist.is_initialized()


def test_cli_writes_the_cell_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "jedinet-30p", "--shape", "stream_1k", "--mesh", "single",
         "--include-jedi", "--no-cost-variant", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "dry-run: 1 ok, 0 failed" in res.stdout
    rec = json.loads((tmp_path / "pod_16x16" /
                      "jedinet-30p__stream_1k.json").read_text())
    assert rec["status"] == "ok" and rec["roofline"]["bound"] == "memory"
