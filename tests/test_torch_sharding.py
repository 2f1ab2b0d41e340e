"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the reference's, spec for spec, and the port's meshes and ``constrain``.

The first seven tests are the counterparts of ``tests/test_sharding.py``.
The parity tests take every registry arch at full width: the reference's
``(path, shape)`` pairs come from ``jax.eval_shape`` of its init (no
memory), the port's trees are the same shapes as ``meta`` tensors, and
each side's specs come from its own functions (the reference's on a
``jax.sharding.AbstractMesh``, the port's on a duck-typed mesh).  The
production meshes are built over the ``fake`` process-group backend in
this process; ``constrain`` inside a context runs on 4 ``gloo`` ranks.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.common.tree import path_map as jpath_map
from repro.configs.registry import ALL_ARCHS, get_arch as jget_arch
from repro.core import interaction_net as jinet
from repro.launch import steps as jsteps
from repro.models import recsys as jrec
from repro.models import transformer as jtfm
from repro.models.gnn import GNN_MODULES as JGNN
from repro.parallel import sharding as jshd
from repro.training import make_optimizer as j_make_optimizer
from repro.training.schedule import constant as jconstant
from repro_torch.common.tree import path_map
from repro_torch.configs.registry import get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.parallel import sharding as shd
from repro_torch.training import make_optimizer
from repro_torch.training.schedule import constant
from torch_ranks import run_ranks


class FakeMesh:
    """Duck-typed mesh: axis_names + shape dict (enough for spec logic)."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


# --- counterparts of tests/test_sharding.py ----------------------------------

def test_filter_axes_drops_missing():
    m = FakeMesh({"data": 16, "model": 16})
    assert shd._filter_axes(("pod", "data"), m) == "data"
    assert shd._filter_axes(("pod",), m) is None
    assert shd._filter_axes(("data", "model"), m) == ("data", "model")


def test_divisible_entry_prefix_rule():
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert shd._divisible_entry(512, ("pod", "data", "model"), m) == \
        ("pod", "data", "model")
    assert shd._divisible_entry(32, ("pod", "data", "model"), m) == \
        ("pod", "data")
    assert shd._divisible_entry(7, ("pod", "data", "model"), m) is None
    assert shd._divisible_entry(8, ("model",), m) is None


def test_logical_to_spec_known_axes():
    m = FakeMesh({"data": 16, "model": 16})
    spec = shd.logical_to_spec(("batch", None, "heads"), m,
                               shd.DEFAULT_RULES)
    assert spec == shd.P("data", None, "model")
    assert tuple(spec) == ("data", None, "model")
    with pytest.raises(KeyError):
        shd.logical_to_spec(("nope",), m, shd.DEFAULT_RULES)


def test_param_rules_lm_paths():
    m = FakeMesh({"data": 16, "model": 16})
    spec = shd._spec_for_path("layers/attn/wq/w", 3, m, shd.DEFAULT_RULES,
                              (4, 2048, 2048))
    assert tuple(spec) == (None, "data", "model")
    spec = shd._spec_for_path("layers/moe/experts/w_gate", 4, m,
                              shd.DEFAULT_RULES, (4, 128, 2048, 4864))
    assert tuple(spec) == (None, "data", None, "model")
    spec = shd._spec_for_path("embed/w", 2, m, shd.DEFAULT_RULES,
                              (32000, 4096))
    assert tuple(spec) == ("model", "data")
    spec = shd._spec_for_path("gnn_layers/0/w", 2, m, shd.DEFAULT_RULES,
                              (1433, 16))
    assert tuple(spec) == (None, None)


def test_train_state_shardings_structure():
    """Adafactor factored accs inherit the param spec minus reduced dim."""
    m = FakeMesh({"data": 16, "model": 16})
    params = {"layers": {"attn": {"wq": {
        "w": torch.empty((4, 2048, 2048), device="meta")}}}}
    opt = make_optimizer("adafactor", constant(1e-3))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    sh = shd.train_state_shardings(state, m)
    assert tuple(sh["params"]["layers"]["attn"]["wq"]["w"].spec) == \
        (None, "data", "model")
    acc = sh["opt"]["acc"]["layers"]["attn"]["wq"]["w"]
    assert tuple(acc["r"].spec) == (None, "data")     # minus last dim
    assert tuple(acc["c"].spec) == (None, "model")    # minus second-to-last
    assert tuple(sh["step"].spec) == ()


def test_kv_cache_shardings_fallback():
    """kv=8 heads on a 16-way model axis -> seq-sharded cache."""
    m = FakeMesh({"data": 16, "model": 16})

    def cache(kv):
        z = functools.partial(torch.empty, device="meta")
        return {"k": z((32, 128, 32768, kv, 128)),
                "v": z((32, 128, 32768, kv, 128)),
                "slot_pos": z((128, 32768), dtype=torch.int32),
                "pos": z((128,), dtype=torch.int32)}
    sh = shd.kv_cache_shardings(cache(8), m)
    assert tuple(sh["k"].spec) == (None, "data", "model", None, None)
    sh = shd.kv_cache_shardings(cache(16), m)
    assert tuple(sh["k"].spec) == (None, "data", None, "model", None)


def test_constrain_is_noop_without_context():
    x = torch.ones((4, 4))
    y = shd.constrain(x, "batch", None)
    assert y is x


# --- the rules and placements ------------------------------------------------

def test_rules_tables_are_the_references():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert shd.PARAM_RULES == jshd.PARAM_RULES


def test_every_rule_names_its_mesh_axes_in_mesh_order():
    for name, axes in shd.DEFAULT_RULES.items():
        idx = [shd.MESH_AXES.index(a) for a in axes]
        assert idx == sorted(idx), name


def test_placements_shard_each_mesh_dim_a_dimension_names():
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    s = shd.NamedSharding(m, shd.P(("pod", "data", "model"), None))
    assert s.placements == (Shard(0), Shard(0), Shard(0))
    s = shd.NamedSharding(m, shd.P(None, "data", "model"))
    assert s.placements == (Replicate(), Shard(1), Shard(2))
    assert shd.NamedSharding(m, shd.P()).placements == (Replicate(),) * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        shd.NamedSharding(m, shd.P(("model", "data"))).placements


# --- parity with the reference at full width ---------------------------------

@functools.lru_cache(maxsize=None)
def _abstract_params(arch_id):
    arch = jget_arch(arch_id)
    cfg = arch.model
    if arch.family == "lm":
        def f(k):
            return jtfm.init(k, cfg)
    elif arch.family == "gnn":
        shape = next(iter(arch.runnable_shapes().values()))

        def f(k):
            return JGNN[cfg.kind].init(k, cfg, jsteps._gnn_feat_dim(shape),
                                       cfg.n_classes)
    elif arch.family == "recsys":
        def f(k):
            return jrec.init(k, cfg)
    else:
        def f(k):
            return jinet.init(k, cfg)
    return jax.eval_shape(f, jax.random.PRNGKey(0))


def _meta(tree):
    """The same shapes as ``meta`` tensors (dtype kept where torch has it)."""
    def one(_p, leaf):
        dt = getattr(torch, str(leaf.dtype), torch.float32)
        return torch.empty(tuple(leaf.shape), dtype=dt, device="meta")
    return jpath_map(one, tree)


def _specs(shardings, walk) -> dict:
    out = {}
    walk(lambda p, s: out.__setitem__(p, tuple(s.spec)) or s, shardings)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch_id", ALL_ARCHS)
def test_param_specs_match_the_reference(arch_id, mesh):
    a_params = _abstract_params(arch_id)
    want = _specs(jshd.param_shardings(
        a_params, AbstractMesh(tuple(MESHES[mesh].values()),
                               tuple(MESHES[mesh]))), jpath_map)
    got = _specs(shd.param_shardings(_meta(a_params), FakeMesh(MESHES[mesh])),
                 path_map)
    assert got == want
    # and _spec_for_path leaf by leaf on the reference's (path, shape)
    fm = FakeMesh(MESHES[mesh])
    jpath_map(lambda p, leaf: (tuple(shd._spec_for_path(
        p, len(leaf.shape), fm, shd.DEFAULT_RULES, tuple(leaf.shape)))
        == want[p]) or pytest.fail(p), a_params)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch_id", ALL_ARCHS)
def test_train_state_specs_match_the_reference(arch_id, opt_name):
    a_params = _abstract_params(arch_id)
    a_state = {"params": a_params,
               "opt": jax.eval_shape(
                   j_make_optimizer(opt_name, jconstant(1e-3)).init,
                   a_params),
               "step": jax.ShapeDtypeStruct((), jnp.int32)}
    axes = MESHES["16x16"]
    want = _specs(jshd.train_state_shardings(
        a_state, AbstractMesh(tuple(axes.values()), tuple(axes))), jpath_map)
    params = _meta(a_params)
    state = {"params": params,
             "opt": make_optimizer(opt_name, constant(1e-3)).init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    got = _specs(shd.train_state_shardings(state, FakeMesh(axes)), path_map)
    assert got == want


LM_ARCHS = [a for a in ALL_ARCHS if jget_arch(a).family == "lm"]


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_kv_cache_specs_match_the_reference(arch_id):
    jcfg, cfg = jget_arch(arch_id).model, get_arch(arch_id).model
    batch, max_seq = 128, 32768
    want = _specs(jshd.kv_cache_shardings(
        jax.eval_shape(lambda: jtfm.init_cache(jcfg, batch, max_seq)),
        AbstractMesh((16, 16), ("data", "model"))), jpath_map)
    cache = tfm.init_cache(cfg, batch, max_seq, device="meta")
    got = _specs(shd.kv_cache_shardings(
        cache, FakeMesh(MESHES["16x16"])), path_map)
    assert got == want


def test_batch_shardings_trim_to_a_dividing_prefix():
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    batch = {"x": torch.empty((64, 30, 16), device="meta"),
             "y": torch.empty((7,), device="meta"),
             "w": torch.empty((3,), device="meta")}
    sh = shd.batch_shardings(batch, m, {"x": ("batch", None, None),
                                        "y": ("batch",)})
    assert tuple(sh["x"].spec) == (("pod", "data"), None, None)
    assert tuple(sh["y"].spec) == (None,)
    assert tuple(sh["w"].spec) == ()


# --- meshes ------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_over_the_fake_backend(multi_pod):
    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=5,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        assert mesh.mesh_dim_names == names
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert shd.mesh_axes(mesh) == dict(
            zip(names, (2, 16, 16) if multi_pod else (16, 16)))
        # rank 5 holds its block of an embedding sharded (vocab, fsdp)
        w = torch.zeros((32000, 4096))
        sh = shd.param_shardings({"embed": {"w": w}}, mesh)["embed"]["w"]
        assert tuple(sh.spec) == ("model", "data")
        d = shd.distribute({"w": w}, {"w": sh})["w"]
        assert isinstance(d, DTensor) and tuple(d.shape) == (32000, 4096)
        assert tuple(d.to_local().shape) == (2000, 256)
    finally:
        dist.destroy_process_group()


# --- constrain inside a context ----------------------------------------------

def _rank_constrain(rank, world, out):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    x = shd.distribute({"x": full},
                       {"x": shd.NamedSharding(mesh, shd.P())})["x"]
    plain = torch.ones(3)
    outside = shd.constrain(x, "batch", "heads")
    with shd.axis_rules(mesh):
        assert shd.current_mesh() is mesh
        y = shd.constrain(x, "batch", "heads")
        same = shd.constrain(y, "batch", "heads")
        z = shd.constrain(y, "tokens", None)
        kept = shd.constrain(plain, "batch")
        # a plain tensor meets a DTensor as if replicated
        s = (y * torch.full((6,), 2.0)).full_tensor()
    assert shd.current_mesh() is None
    res = {"outside_is_x": outside is x, "same_is_y": same is y,
           "plain_kept": kept is plain,
           "y_placements": tuple(y.placements),
           "y_local": tuple(y.to_local().shape),
           "z_placements": tuple(z.placements),
           "z_local": tuple(z.to_local().shape),
           "y_full": y.full_tensor(), "z_full": z.full_tensor(),
           "scaled": s, "full": full}
    if rank == 0:
        torch.save(res, out)


def test_constrain_redistributes_a_dtensor_inside_a_context(tmp_path):
    run_ranks(_rank_constrain, 4, tmp_path, tmp_path / "out.pt")
    r = torch.load(tmp_path / "out.pt")
    assert r["outside_is_x"] and r["same_is_y"] and r["plain_kept"]
    assert r["y_placements"] == (Shard(0), Shard(1))
    assert r["y_local"] == (4, 3)
    # "tokens" spans data and model: the batch dim split 4 ways
    assert r["z_placements"] == (Shard(0), Shard(0))
    assert r["z_local"] == (2, 6)
    assert torch.equal(r["y_full"], r["full"])
    assert torch.equal(r["z_full"], r["full"])
    assert torch.equal(r["scaled"], 2 * r["full"])
