"""Multi-pod dry run: every (architecture x input shape) cell, and the
paper's DMRG cells, on the production meshes, with the per-rank roofline
of each step.

The reference lowers and compiles each cell for 256 or 512 placeholder
TPU devices and reads XLA's memory and cost analysis.  The port runs the
cell's step once on fake tensors (``FakeTensorMode``: no data, no
allocation) over a fake process group of 256 or 512 ranks in this one
process (``launch/mesh.make_production_mesh``): parameters, moments,
caches and batches are DTensors placed by their logical axes
(``launch/sharding.py``), flash attention and the RWKV6 scan go through
their kernels' fake implementations (the step counted is the one the card
would run), and ``launch/costs.py`` counts this rank's flops, bytes,
collectives and peak bytes while it runs.  The roofline terms use the
H100 SXM5's spec-sheet rates (``launch/mesh.HW``): they are modelled, not
measured.  It needs no card.

Each cell writes ``<out>/<arch>_<shape>_<mesh>.json`` with the reference's
keys (``lower_s`` is the seconds to place the fake arguments,
``compile_s`` the seconds of the counted run); completed cells are skipped
unless ``--force``.  A cell that raises prints ``FAIL`` and the run exits
nonzero.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all      # every cell, both meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --dmrg     # the paper's DMRG cells
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def model_flops_estimate(arch: str, shape_name: str) -> float:
    """6*N*D for train (N = active params, D = tokens); 2*N*D for fwd-only;
    decode: 2*N per token * batch (one step)."""
    from ..configs import SHAPES, get_config

    cfg = get_config(arch)
    info = SHAPES[shape_name]
    n = cfg.active_param_count()
    if info["kind"] == "train":
        return 6.0 * n * info["global_batch"] * info["seq_len"]
    if info["kind"] == "prefill":
        return 2.0 * n * info["global_batch"] * info["seq_len"]
    return 2.0 * n * info["global_batch"]  # decode: one token per sequence


def _place(meta, placements, mesh):
    """A fake tensor shaped as the meta tensor ``meta``, distributed onto
    ``placements`` (this rank keeps its shard); trees map element-wise;
    anything else (an int position) passes as it is."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    if isinstance(meta, dict):
        return {k: _place(v, placements[k], mesh) for k, v in meta.items()}
    if isinstance(meta, (tuple, list)):
        return type(meta)(_place(v, p, mesh) for v, p in zip(meta, placements))
    if not isinstance(meta, torch.Tensor):
        return meta
    full = torch.empty(meta.shape, dtype=meta.dtype)
    return full if placements is None else distribute_tensor(full, mesh, placements, src_data_rank=None)


def _constrain(out, placements):
    """Outputs redistributed to the cell's out_shardings, as the reference's
    ``jit(out_shardings=)`` places them."""
    from ..models.common import is_dtensor

    if isinstance(out, dict):
        return {k: _constrain(v, placements[k]) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        if isinstance(placements, (tuple, list)) and len(placements) == len(out) and not _is_placement(placements):
            return type(out)(_constrain(v, p) for v, p in zip(out, placements))
        return out
    if is_dtensor(out) and placements is not None and tuple(out.placements) != tuple(placements):
        return out.redistribute(out.device_mesh, placements)
    return out


def _is_placement(p) -> bool:
    from torch.distributed.tensor.placement_types import Placement

    return len(p) > 0 and all(isinstance(x, Placement) for x in p)


@contextlib.contextmanager
def _strided_index_math_on_real_tensors():
    """DTensor computes which rows of a dim that two mesh dims shard (a
    ``_StridedShard``, as after a reshape that merges batch and sequence)
    a rank holds with ``torch.arange`` and ``tolist``, which a fake tensor
    cannot answer; that index arithmetic runs outside the fake mode here."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    inner = _StridedShard.local_shard_size_and_offset

    def on_real_tensors(*args, **kwargs):
        with unset_fake_temporarily():
            return inner(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = on_real_tensors
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = inner


@contextlib.contextmanager
def _strided_costs_estimated():
    """To pick an op's sharding strategy DTensor prices every candidate's
    redistribution; one that involves a ``_StridedShard`` it prices by a
    shortest-path search over every placement of every mesh dim, which
    takes minutes per cell on a mesh of three dims.  Here such a price is
    estimated instead: the local shard's bytes once per mesh dim whose
    placement changes (the redistribution itself, once chosen, is still
    planned by DTensor's search)."""
    from torch.distributed.tensor import _ops
    from torch.distributed.tensor._collective_utils import spec_to_bytes
    from torch.distributed.tensor.placement_types import _StridedShard

    priced = _ops.utils.redistribute_cost

    def estimated(src, dst):
        if not any(isinstance(p, _StridedShard) for p in (*src.placements, *dst.placements)):
            return priced(src, dst)
        changed = sum(a != b for a, b in zip(src.placements, dst.placements))
        return changed * spec_to_bytes(src) / src.num_shards / 2**30

    _ops.utils.redistribute_cost = estimated
    try:
        yield
    finally:
        _ops.utils.redistribute_cost = priced


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path, force: bool = False) -> dict:
    mesh_name = "pod512" if multi_pod else "pod256"
    out_path = Path(out_dir) / f"{arch}_{shape_name}_{mesh_name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..configs import get_config
    from . import mesh as mesh_mod
    from . import specs
    from .costs import counting, local_bytes

    t0 = time.time()
    created = not dist.is_initialized()
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    try:
        n_chips = mesh.size()
        rec = dict(arch=arch, shape=shape_name, mesh=mesh_name, chips=n_chips)
        if arch.endswith("_list"):
            fn, args, in_sh, out_sh, _ = specs.dmrg_list_cell(arch, mesh)
        elif arch.startswith("dmrg"):
            fn, args, in_sh, out_sh, _ = specs.dmrg_cell(arch, mesh)
        else:
            cfg = get_config(arch)
            ok, why = cfg.shape_supported(shape_name)
            if not ok:
                rec.update(status="skipped", reason=why)
                out_path.parent.mkdir(parents=True, exist_ok=True)
                out_path.write_text(json.dumps(rec, indent=1))
                return rec
            fn, args, in_sh, out_sh, _ = specs.lm_cell(arch, shape_name, mesh)

        with FakeTensorMode(), _strided_index_math_on_real_tensors(), _strided_costs_estimated():
            placed = _place(args, in_sh, mesh)
            t_lower = time.time() - t0
            arg_bytes = local_bytes(placed)
            with counting(mesh_mod.HW) as counter:
                counter.exclude(placed)
                out = _constrain(fn(*placed), out_sh)
                out_bytes = local_bytes(out)
                alias = local_bytes([o for o in _leaves(out) if any(o is a for a in _leaves(placed))])
            t_compile = time.time() - t0 - t_lower
        tc = counter.totals()
    finally:
        if created:
            dist.destroy_process_group()

    hw = mesh_mod.HW
    flops_per_chip, bytes_per_chip = float(tc["flops"]), float(tc["bytes"])
    terms = dict(compute=flops_per_chip / hw["peak_flops_bf16"], memory=bytes_per_chip / hw["hbm_bw"],
                 collective=tc["coll_s"])
    dominant = max(terms, key=terms.get)
    mf = 0.0 if arch.startswith("dmrg") else model_flops_estimate(arch, shape_name)
    rec.update(
        status="ok",
        lower_s=round(t_lower, 2),
        compile_s=round(t_compile, 2),
        memory=dict(
            argument_bytes=arg_bytes,
            output_bytes=out_bytes,
            temp_bytes=tc["peak_temp"],
            alias_bytes=alias,
            # the arguments and the most that the step held at once beside them
            # (its outputs included: they are alive at its end)
            peak_bytes=arg_bytes + tc["peak_temp"],
            hbm_bytes=hw["hbm_bytes"],
        ),
        flops_per_chip=flops_per_chip,
        bytes_per_chip=bytes_per_chip,
        collective=tc["coll"],
        roofline=dict(compute_s=terms["compute"], memory_s=terms["memory"], collective_s=terms["collective"],
                      dominant=dominant, step_s_lower_bound=max(terms.values())),
        model_flops_global=mf,
        model_flops_per_chip=mf / n_chips,
        useful_flops_ratio=(mf / n_chips / flops_per_chip) if flops_per_chip else 0.0,
    )
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


DMRG_NAMES = ("dmrg_spins", "dmrg_electrons", "dmrg_spins_opt", "dmrg_electrons_opt", "dmrg_spins_list",
              "dmrg_electrons_list")


def all_cells(include_dmrg: bool = True):
    from ..configs import ARCH_IDS, SHAPES

    cells = [(arch, shape) for arch in ARCH_IDS for shape in SHAPES]
    if include_dmrg:
        cells += [(name, "davidson_m32k") for name in DMRG_NAMES]
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dmrg", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(ART))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all or args.dmrg:
        cells = all_cells() if args.all else [(n, "davidson_m32k") for n in ("dmrg_spins", "dmrg_electrons")]
        failures = 0
        for arch, shape in cells:
            for mp in (False, True):
                tag = f"{arch} x {shape} [{'pod512' if mp else 'pod256'}]"
                try:
                    rec = run_cell(arch, shape, mp, out_dir, force=args.force)
                    if rec["status"] == "ok":
                        r = rec["roofline"]
                        print(f"OK   {tag}: dominant={r['dominant']} step>={r['step_s_lower_bound']:.4f}s "
                              f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB (compile {rec['compile_s']:.0f}s)",
                              flush=True)
                    else:
                        print(f"SKIP {tag}: {rec['reason']}", flush=True)
                except Exception as e:
                    failures += 1
                    print(f"FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
        sys.exit(1 if failures else 0)

    rec = run_cell(args.arch, args.shape, args.multi_pod, out_dir, force=args.force)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
