"""Multi-pod dry-run: build and run every (architecture x input shape) on
the production meshes of fake ranks and emit roofline terms.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell with XLA on 512 placeholder CPU devices.  Here the process joins a
``fake`` process group of 256 (or 512) ranks as rank 0 (its collectives
return at once and move nothing), builds the production ``DeviceMesh``
over it, and runs one step of the cell on ``DTensor``s whose local
shards are fake tensors of rank 0's shapes, under ``FakeTensorMode``: no
tensor is allocated at any width, and every op runs its shape logic, so
a sharding the ops cannot take, or an op DTensor has no rule for, fails
the cell.

Per cell:
    1. init the ``fake`` group (process-global: destroyed after the
       cell) and ``make_production_mesh(device_type="cpu")``,
    2. build the program (``repro_torch.launch.steps.build_cell``) and its
       abstract args and shardings, placed as DTensors
       (``steps.place``) — timed as ``lower_s``,
    3. run the step once under ``axis_rules(mesh)`` inside the roofline
       counter (``launch/roofline.py``: FLOPs by dtype, bytes,
       collectives and live storage of the ops rank 0 runs) — timed as
       ``compile_s``,
    4. write the record into ``<out>/<mesh>/<arch>__<shape>.json`` with
       the reference's keys (``roofline``, ``collectives``, ``memory``,
       ``status``, ``kind``, ``notes``, ``lower_s``, ``compile_s``).

No cost variant: XLA's cost analysis counts a ``while`` body once, so the
reference re-lowers its scan-based programs unrolled
(``_cost_variant``).  The port has no ``lax.scan``: its layer, chunk and
edge loops are Python loops that run every trip, and the counter sees
every op of every trip in the one pass.  ``--no-cost-variant`` is
accepted for the reference's CLI and does nothing.

Usage:
    python -m repro_torch.launch.dryrun                  # all cells, both meshes
    python -m repro_torch.launch.dryrun --arch fm --shape train_batch
    python -m repro_torch.launch.dryrun --mesh single --include-jedi
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback


def count_cell(arch, shape, mesh) -> dict:
    """One fake step of ``arch`` x ``shape`` on ``mesh`` (an initialised
    mesh of any device type), counted: the record's ``roofline``,
    ``collectives``, ``memory``, ``kind``, ``notes``, ``lower_s``
    (abstract state built and placed) and ``compile_s`` (the step)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import roofline
    from repro_torch.launch.steps import build_cell, place
    from repro_torch.parallel.sharding import axis_rules

    t0 = time.time()
    prog = build_cell(arch, shape, mesh)
    args, in_sh, _ = prog.make_abstract()
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    dargs = place(args, in_sh, fake_mode)
    t_lower = time.time() - t0
    counter = roofline.StepCounter(fake_mode, mesh)
    counter.track_args(dargs)
    with fake_mode, counter, axis_rules(mesh):
        out = prog.step_fn(*dargs)
    t_step = time.time() - t0 - t_lower
    rec = roofline.record(counter, int(mesh.size()), out, dargs)
    rec.update({"kind": prog.kind, "notes": prog.notes,
                "lower_s": round(t_lower, 2), "compile_s": round(t_step, 2)})
    return rec


def run_cell(arch_id, shape_name, multi_pod: bool, out_dir: str,
             no_cost_variant: bool = False) -> dict:
    """The cell's record on the (16, 16) or (2, 16, 16) mesh of fake
    ranks; ``arch_id`` / ``shape_name`` may be an ``ArchSpec`` /
    ``ShapeSpec`` (a reduced cell).  A failure is recorded, not raised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_production_mesh

    arch = get_arch(arch_id) if isinstance(arch_id, str) else arch_id
    shape = (arch.shapes[shape_name] if isinstance(shape_name, str)
             else shape_name)
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    world = 512 if multi_pod else 256

    rec = {
        "arch": arch.arch_id, "shape": shape.name, "mesh": mesh_name,
        "chips": world, "status": "error",
    }
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rec.update(count_cell(arch, shape, mesh))
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        dist.destroy_process_group()

    if out_dir:
        os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
        path = os.path.join(out_dir, mesh_name,
                            f"{arch.arch_id}__{shape.name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--include-jedi", action="store_true",
                    help="also run the paper's own jedinet cells")
    ap.add_argument("--no-cost-variant", action="store_true",
                    help="accepted for the reference's CLI; the port has "
                         "no cost variant (every loop trip is counted)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import ALL_ARCHS, ASSIGNED_ARCHS, \
        get_arch

    archs = ([args.arch] if args.arch
             else (ALL_ARCHS if args.include_jedi else ASSIGNED_ARCHS))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_fail = 0
    t_all = time.time()
    for arch_id in archs:
        spec = get_arch(arch_id)
        shapes = ([args.shape] if args.shape
                  else list(spec.runnable_shapes()))
        for shape_name in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                tag = f"{arch_id} x {shape_name} @ {mesh_name}"
                t0 = time.time()
                rec = run_cell(arch_id, shape_name, mp, args.out,
                               no_cost_variant=args.no_cost_variant)
                dt = time.time() - t0
                if rec["status"] == "ok":
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"[ok]   {tag}: bound={r['bound']} "
                          f"step={r['step_s']*1e3:.2f}ms "
                          f"(c={r['compute_s']*1e3:.2f} "
                          f"m={r['memory_s']*1e3:.2f} "
                          f"x={r['collective_s']*1e3:.2f}) {dt:.0f}s",
                          flush=True)
                else:
                    n_fail += 1
                    print(f"[FAIL] {tag}: {rec['error']}", flush=True)
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed "
          f"({time.time() - t_all:.0f} s)")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
