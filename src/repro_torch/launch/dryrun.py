"""Dry run of every (architecture x input shape) on the production mesh
(port of ``repro.launch.dryrun``): place every leaf, check that it fits,
and print the roofline terms.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape decode_32k [--multi-pod] [--no-tarragon] [--json out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--include-paper-model] [--multi-pod]

The reference lowers and compiles each case on 512 fake host devices.
The port has no compiler to ask; in its place each case is checked on
torch's fake process group (256 or 512 ranks, rank 0, ``cuda`` device
type, no card needed):

* the production mesh builds;
* every param, optimizer-state, cache and batch leaf, a ``meta`` tensor,
  is placed as a DTensor by the ``Sharder``'s spec, and its shard at rank
  0 has the shape the spec promises (each split dim divides evenly);
* one device's bytes of params, optimizer state, cache and batch, against
  the card's 80 GB (the reference's ``memory_analysis`` arguments);
* the roofline terms of ``roofline/analysis.py``.

What only a compile could show is not checked: temporaries (activations,
the optimizer's float32 working copies), and whether the step runs at
that sharding at all. A case over 80 GB is reported, not an error.
"""
import argparse
import json
import time
import traceback

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import SHAPES, supports_shape
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.launch.sharding import ShardingPolicy
from repro_torch.launch.specs import adapt_config, build_case
from repro_torch.roofline import analysis, h100
from repro_torch.training.train import leaf_paths


def check_placements(case) -> int:
    """Hold every leaf of the case, placed on the mesh, to the spec's
    local shape at rank 0; returns the leaves checked. A shard's shape
    depends on the leaf's shape and spec alone, so each distinct (shape,
    spec) is placed once."""
    sh = case.sharder
    seen = set()
    trees = [(case.params, case.param_specs)]
    if case.opt_state is not None:
        trees += [(case.opt_state.mu, case.param_specs),
                  (case.opt_state.nu, case.param_specs)]
    if case.cache is not None:
        trees.append((case.cache, case.cache_specs))
    n = 0
    for tree, specs in trees:
        for path, t in leaf_paths(tree).items():
            n += _check_leaf(sh, path, t, specs[path], seen)
    for path, t in case.batch.items():
        n += _check_leaf(sh, path, t, sh.batch_spec(t.shape), seen)
    return n


def _check_leaf(sh, path, t, spec, seen) -> int:
    key = (tuple(t.shape), spec)
    if key in seen:
        return 1
    seen.add(key)
    for s, e in zip(t.shape, spec):
        if e is not None and s % sh.axis_size(e):
            raise ValueError(f"{path}: dim {s} does not split over {e}")
    got = tuple(sh.place(t, spec).to_local().shape)
    want = sh.local_shape(t.shape, spec)
    if got != want:
        raise ValueError(f"{path}: shard {got}, spec {spec} gives {want}")
    return 1


def run_case(arch: str, shape_name: str, mesh, *, multi_pod: bool = False,
             tarragon: bool = True, policy: ShardingPolicy = None,
             verbose: bool = True) -> dict:
    shape = SHAPES[shape_name]
    cfg = adapt_config(get_config(arch), shape)
    if not supports_shape(cfg, shape):
        return {"name": f"{arch}:{shape_name}", "status": "skipped",
                "reason": "no sub-quadratic long-context path"}
    t0 = time.time()
    case = build_case(arch, shape_name, mesh, policy=policy,
                      tarragon=tarragon)
    leaves = check_placements(case)
    rep = analysis.analyze(case)
    t1 = time.time()
    result = rep.to_dict()
    result.update({
        "status": "ok",
        "mesh": "x".join(str(s) for s in mesh.shape),
        "multi_pod": multi_pod,
        "tarragon": tarragon,
        "leaves": leaves,
        "fits": rep.mem_per_device_bytes <= h100.HBM_BYTES,
        "check_s": round(t1 - t0, 2),
    })
    if verbose:
        mem = rep.mem_breakdown
        print(f"== {case.name} mesh={result['mesh']} ({leaves} leaves "
              f"checked, {result['check_s']}s)")
        print("   bytes/device: " + " ".join(
            f"{k}={v / 2**30:.2f}GiB" for k, v in mem.items()) +
            f" total={rep.mem_per_device_bytes / 2**30:.2f}GiB "
            f"{'fits' if result['fits'] else 'OVER'} 80 GB")
        print(f"   per device: flops={rep.hlo_flops:.3e} "
              f"bytes={rep.hlo_bytes:.3e} coll={rep.coll_bytes:.3e}")
        print(f"   roofline (H100 SXM spec figures): "
              f"compute={rep.compute_s * 1e3:.3f}ms "
              f"memory={rep.memory_s * 1e3:.3f}ms "
              f"collective={rep.collective_s * 1e3:.3f}ms "
              f"-> {rep.dominant}-bound, useful={rep.useful_ratio:.3f}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-paper-model", action="store_true",
                    help="also sweep mixtral-8x7b (the paper's own model)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-tarragon", action="store_true",
                    help="MegaScale-style static binding baseline")
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args(argv)

    cases = []
    if args.all:
        archs = list(ASSIGNED_ARCHS)
        if args.include_paper_model:
            archs.append("mixtral_8x7b")
        for arch in archs:
            arch_name = get_config(arch).name
            for shape_name in SHAPES:
                cases.append((arch_name, shape_name))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cases.append((args.arch, args.shape))

    results = []
    world = 512 if args.multi_pod else 256
    with fake_group(world):
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        for arch, shape_name in cases:
            try:
                results.append(run_case(arch, shape_name, mesh,
                                        multi_pod=args.multi_pod,
                                        tarragon=not args.no_tarragon))
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                results.append({"name": f"{arch}:{shape_name}",
                                "status": "error", "error": str(e)})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
