"""Which collectives a gloo world carries on CUDA tensors: each rank writes
``OUT/<rank>.json`` with, per collective that mesh training issues
(DTensor's functional collectives: all_reduce, all_gather_into_tensor,
reduce_scatter_tensor, all_to_all_single; and the c10d calls of the same
names), whether it ran, whether its result is right, and its error if it
raised.  Nothing is caught to hide a refusal: each one is written down.
``--skip`` leaves collectives out: one that kills the process (gloo's
functional all-gather on the H100 does) would take the others down with
it, and run alone it shows as the probe's exit status.

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        scripts/gloo_cuda_probe.py --out chiprun_out/gloo_probe
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--skip", default="", help="comma-separated collectives not to probe")
    args = ap.parse_args()

    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.launch.mesh import init_world, local_device

    init_world("cuda", backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = local_device("cuda")
    torch.cuda.set_device(dev)
    group = dist.group.WORLD
    base = torch.arange(4 * world, dtype=torch.float32, device=dev) + 100 * rank
    every = [torch.arange(4 * world, dtype=torch.float32, device=dev) + 100 * r for r in range(world)]

    def want(name):
        if name == "all_reduce":
            return sum(every)
        if name == "all_gather_into_tensor":
            return torch.cat([e[:4] for e in every])
        if name == "reduce_scatter_tensor":
            return sum(every)[4 * rank:4 * rank + 4]
        return torch.cat([e[4 * rank:4 * rank + 4] for e in every])  # all_to_all_single

    calls = {
        "funcol.all_reduce": lambda: funcol.wait_tensor(funcol.all_reduce(base.clone(), "sum", group)),
        "funcol.all_gather_into_tensor": lambda: funcol.wait_tensor(
            funcol.all_gather_tensor(base[:4].clone(), 0, group)),
        "funcol.reduce_scatter_tensor": lambda: funcol.wait_tensor(
            funcol.reduce_scatter_tensor(base.clone(), "sum", 0, group)),
        "funcol.all_to_all_single": lambda: funcol.wait_tensor(
            funcol.all_to_all_single(base.clone(), [4] * world, [4] * world, group)),
    }

    def c10d(name):
        if name == "all_reduce":
            t = base.clone()
            dist.all_reduce(t)
            return t
        out = torch.empty(4 * world if name == "all_gather_into_tensor" else 4 if name == "reduce_scatter_tensor"
                          else 4 * world, dtype=torch.float32, device=dev)
        if name == "all_gather_into_tensor":
            dist.all_gather_into_tensor(out, base[:4].clone())
        elif name == "reduce_scatter_tensor":
            dist.reduce_scatter_tensor(out, base.clone())
        else:
            dist.all_to_all_single(out, base.clone())
        return out

    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single"):
        calls[f"c10d.{name}"] = lambda name=name: c10d(name)
    record = {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(dev), "ops": {}}
    for label, call in calls.items():
        if label in args.skip.split(","):
            continue
        name = label.split(".", 1)[1]
        try:
            got = call()
            torch.cuda.synchronize(dev)
            record["ops"][label] = dict(ran=True, right=bool(torch.equal(got.cpu(), want(name).cpu())))
        except Exception as e:  # a refusal is the finding: written down, not hidden
            record["ops"][label] = dict(ran=False, error=f"{type(e).__name__}: {str(e)[:300]}")
        dist.barrier()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{rank}.json"), "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
