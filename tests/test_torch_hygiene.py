"""The port stands alone: no JAX and nothing of the JAX package.

Every module under ``src/repro_torch/`` and ``chip_smoke.py`` is parsed
and its imports checked, and the whole package is imported in a fresh
interpreter where ``triton`` cannot be imported and no card is visible.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(root, line) for root, line in _imported_roots(tree)
           if root in BANNED]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_has_modules_to_check():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for required in ("bridge.py", "kernels/fused_jedinet/full_kernel.py",
                     "serving/resilient.py", "launch/trigger_serve.py",
                     "models/__init__.py", "models/recsys.py",
                     "kernels/fm_interaction/kernel.py",
                     "kernels/flash_decode/kernel.py",
                     "serving/sentinel.py", "serving/loop.py",
                     "serving/batcher.py", "core/codesign.py",
                     "common/tree.py", "training/optimizer.py",
                     "training/schedule.py", "training/trainer.py",
                     "training/grad_compression.py",
                     "checkpoint/checkpoint.py", "launch/train.py",
                     "examples/train_jedinet.py",
                     "examples/codesign_search.py",
                     "configs/h2o_danube_1_8b.py", "configs/minicpm_2b.py",
                     "configs/phi3_medium_14b.py", "nn/rope.py",
                     "nn/attention.py", "models/transformer.py",
                     "serving/lm.py", "launch/serve.py",
                     "examples/serve_lm.py", "models/gnn/segment_ops.py",
                     "models/gnn/gcn.py", "models/gnn/pna.py",
                     "models/gnn/meshgraphnet.py", "models/gnn/so3.py",
                     "models/gnn/equiformer_v2.py", "data/graphs.py",
                     "data/neighbor_sampler.py", "launch/steps.py",
                     "configs/gcn_cora.py", "configs/equiformer_v2.py"):
        assert required in names


_IMPORT_ALL = """
import importlib, pkgutil, sys

class _NoTriton:
    def find_spec(self, name, path=None, target=None):
        if name == "triton" or name.startswith("triton."):
            raise ImportError("triton is blocked in this check")
        return None

sys.meta_path.insert(0, _NoTriton())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import torch
assert not torch.cuda.is_available()
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
assert not leaked, leaked
print(len(mods))
"""


def test_port_imports_without_triton_or_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_cuda_without_a_card_raises_instead_of_falling_back():
    import torch

    from repro_torch import resolve_device
    from repro_torch.core import interaction_net as inet
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        inet.init(0, inet.JediNetConfig())      # entry points default to cuda
