"""Several runs in one world, one after another: the argument groups are
separated by ``---``, and each is one run of the train CLI
(``launch/train.py``: its own ``--mesh-model``, ``--record``, ``--resume``
...), or, when it starts with ``grads``, of the float32 gradient check
``scripts/mesh_grads.py``.  The world is started once, on the first
group's ``--device`` (gloo where its ranks outnumber the cards,
``launch/mesh.backend_for``), and outlives every run, so ranks pay one
start-up for all of them.  Under torchrun::

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        scripts/mesh_runs.py --arch whisper_tiny --smoke --device cpu --mesh-model 2 --steps 2 \\
        --checkpoint-every 2 --checkpoint-dir CKPT --record OUT/first \\
        --- --arch whisper_tiny --smoke --device cpu --mesh-model 1 --steps 4 --resume auto \\
        --checkpoint-dir CKPT --record OUT/resumed \\
        --- grads --arch rwkv6_3b --smoke --device cpu --seq-len 64 --out OUT/grads

Ranks that share one card carry CUDA tensors over gloo, whose functional
all-gather kills the process with torch 2.11 on the H100 where c10d's
``all_gather_into_tensor`` of the same tensors runs right
(``scripts/gloo_cuda_probe.py``); while these runs last, ``gloo_gathers``
sends DTensor's functional all-gathers through c10d's call.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))


@contextlib.contextmanager
def gloo_gathers():
    """While inside, in a gloo world on CUDA tensors, route the functional
    all-gathers (``_functional_collectives.all_gather_tensor`` /
    ``all_gather_single``, what DTensor's redistribution calls) through
    c10d's ``all_gather_into_tensor``, which completes before it returns;
    DTensor's own autograd wraps the call.  Elsewhere nothing changes."""
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh

    def group_of(group):
        if isinstance(group, tuple) and len(group) == 2 and isinstance(group[0], DeviceMesh):
            return group[0].get_group(group[1])
        if isinstance(group, DeviceMesh):
            return group.get_group()
        return group

    saved = {name: getattr(funcol, name) for name in ("all_gather_tensor", "all_gather_single") if hasattr(funcol, name)}
    for name, inner in saved.items():
        def gather(self, gather_dim, group, tag="", inner=inner):
            pg = group_of(group)
            if not isinstance(pg, dist.ProcessGroup) or not self.is_cuda or dist.get_backend(pg) != "gloo":
                return inner(self, gather_dim, group, tag)
            size = pg.size()
            out = self.new_empty((size * self.shape[0],) + tuple(self.shape[1:]))
            dist.all_gather_into_tensor(out, self.contiguous(), group=pg)
            return out if gather_dim == 0 else torch.cat(torch.chunk(out, size, dim=0), dim=gather_dim)

        setattr(funcol, name, gather)
    try:
        yield
    finally:
        for name, inner in saved.items():
            setattr(funcol, name, inner)


def main(argv=None):
    import torch.distributed as dist

    import mesh_grads
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import init_world
    from repro_torch.launch.train import main as train

    argv = sys.argv[1:] if argv is None else argv
    runs, run = [], []
    for a in argv:
        if a == "---":
            runs.append(run)
            run = []
        else:
            run.append(a)
    runs.append(run)
    peek = argparse.ArgumentParser(add_help=False)
    peek.add_argument("--device", default=None)
    known, _ = peek.parse_known_args(runs[0][1:] if runs[0][:1] == ["grads"] else runs[0])
    init_world(resolve_device(known.device).type)
    with gloo_gathers():
        for run in runs:
            if run[:1] == ["grads"]:
                mesh_grads.main(run[1:])
            else:
                train(run)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
