"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: the same numpy data goes into both, and tensors cross as numpy."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from repro.tensor import blocksparse as jbs
from repro.tensor import qn as jqn
from repro_torch.tensor import blocksparse as tbs
from repro_torch.tensor import qn as tqn

IN, OUT = -1, 1
S1 = (((-1,), 2), ((1,), 3))
S2 = (((-2,), 1), ((0,), 3), ((2,), 2))
SP = (((1,), 1), ((-1,), 1))

# (a specs, a charge, b specs, b charge, axes)
CASES = {
    "one_mode": ([(S1, IN, "l"), (SP, OUT, "s"), (S2, OUT, "r")], (0,),
                 [(S2, IN, "l"), (SP, OUT, "s"), (S1, OUT, "r")], (0,), ((2,), (0,))),
    "two_modes": ([(S1, IN, "l"), (SP, OUT, "s"), (S2, OUT, "r")], (0,),
                  [(S2, IN, "l"), (SP, IN, "s"), (S1, OUT, "r")], (0,), ((1, 2), (1, 0))),
    "charged": ([(S1, IN, "l"), (SP, OUT, "s"), (S2, OUT, "r")], (0,),
                [(S2, IN, "l"), (SP, OUT, "s"), (S1, OUT, "r")], (2,), ((2,), (0,))),
}


def specs(indices):
    """Indices of either package as plain ``(sectors, flow, name)`` tuples,
    so that the two packages' ``Index`` classes compare."""
    return [(ix.sectors, ix.flow, ix.name) for ix in indices]


def to_arrays(t):
    """A tensor of either package as ``(index_specs, charge, blocks)``."""
    return specs(t.indices), t.charge, {k: np.asarray(b) for k, b in t.blocks.items()}


def random_pair(rng, specs, charge, pkg_index, pkg_bst, to_block):
    """A random tensor of one package from index specs and a numpy rng;
    ``to_block`` turns each numpy block into the package's array type."""
    indices = [pkg_index(s, f, n) for s, f, n in specs]
    probe = pkg_bst(indices, {}, charge)
    blocks = {}
    for k in probe.valid_keys():
        blocks[k] = to_block(rng.standard_normal(probe.block_shape(k)))
    return pkg_bst(indices, blocks, charge)


def make_both(seed, specs, charge):
    """The same random tensor in both packages."""
    j = random_pair(np.random.default_rng(seed), specs, charge, jqn.Index, jbs.BlockSparseTensor, jnp.asarray)
    t = random_pair(np.random.default_rng(seed), specs, charge, tqn.Index, tbs.BlockSparseTensor, torch.from_numpy)
    return j, t


def mpo_to_dense(tensors) -> np.ndarray:
    """Contract MPO site tensors W[l, o, i, r] (numpy dense) into H[O, I],
    site 0 most significant, as ``core/ed.py`` orders the basis."""
    M = tensors[0][0]  # [o, i, r] from the dim-1 left bond
    for W in tensors[1:]:
        M = np.einsum("OIk,koir->OoIir", M, W)
        a, b, c, d, r = M.shape
        M = M.reshape(a * b, c * d, r)
    return M[:, :, 0]


def assert_blocks_close(got, want, tol):
    """Same indices, charge and block keys, every block within ``tol`` (max
    abs difference)."""
    assert specs(got.indices) == specs(want.indices) and got.charge == want.charge
    assert set(got.blocks) == set(want.blocks)
    for k in want.blocks:
        diff = np.max(np.abs(np.asarray(got.blocks[k]) - np.asarray(want.blocks[k])))
        assert diff <= tol, (k, diff)


def jax_from_arrays(arrays):
    """A JAX package tensor from ``(index_specs, charge, blocks)``."""
    index_specs, charge, blocks = arrays
    return jbs.BlockSparseTensor(
        [jqn.Index(s, f, n) for s, f, n in index_specs],
        {k: jnp.asarray(b) for k, b in blocks.items()},
        charge,
    )


# the slice's settings, as the port's CPU tests run them on both packages
SLICE_KW = dict(sweeps_per_bond=2, davidson_iters=4)


def jax_reference(space, terms, n, bond_schedule):
    """The JAX run the slice is held to: ``algo="list"`` with the seed
    per-sector SVD and the three-call environment updates, on an MPO built
    and compressed by the JAX package.  Returns plain data: the MPO and the
    final MPS as arrays, per-sweep energies and Davidson restarts, and the
    exact ground energy in the Sz=0 sector."""
    from repro.core.dmrg import run_dmrg
    from repro.core.ed import ground_energy
    from repro.core.mpo import build_mpo, compress_mpo, mpo_bond_dims

    mpo = compress_mpo(build_mpo(space, terms, n), cutoff=1e-13)
    res = run_dmrg(
        space, terms, n, bond_schedule=bond_schedule, algo="list",
        svd_method="unplanned", jit_env=False, mpo=mpo, **SLICE_KW,
    )
    return dict(
        mpo=[to_arrays(w) for w in mpo],
        mpo_bond_dims=mpo_bond_dims(mpo),
        mps=[to_arrays(t) for t in res.mps.tensors],
        energies=res.energies,
        restarts=[s.davidson_restarts for s in res.sweep_stats],
        e_ed=ground_energy(space, terms, n, charge=(0,)),
    )


def check_slice(ref, space, terms, n, bond_schedule, algo, ed_tol):
    """The port's ``run_dmrg`` on the carried-across JAX MPO, held to the
    JAX run sweep by sweep (<1e-10) and to exact diagonalization
    (``ed_tol``).  Both sides must restart Davidson equally often; a
    restart draws different random directions in the two packages
    (threefry vs ``torch.Generator``), so a run that restarted is held to ED
    only.  Returns the port's result."""
    from repro_torch.convert import mpo_from_arrays
    from repro_torch.core import run_dmrg

    mpo = mpo_from_arrays(ref["mpo"], device="cpu")
    res = run_dmrg(space, terms, n, bond_schedule=bond_schedule, algo=algo, mpo=mpo, device="cpu", **SLICE_KW)
    restarts = [s.davidson_restarts for s in res.sweep_stats]
    assert abs(res.energy - ref["e_ed"]) <= ed_tol, (res.energy, ref["e_ed"])
    assert all(s.davidson_exhausted == 0 for s in res.sweep_stats)
    assert restarts == ref["restarts"]
    if not any(restarts):
        diffs = np.abs(np.array(res.energies) - np.array(ref["energies"]))
        assert np.all(diffs < 1e-10), (res.energies, ref["energies"])
    return res
