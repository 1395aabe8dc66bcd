"""The port's logical axes and sharding rules (``launch/sharding.py``,
``models.param_axes``, ``models.decode_cache_axes``,
``train.optim.opt_state_axes``) against the reference's.

The reference's ``spec_for`` reads only ``mesh.shape``, so a stand-in with
a ``shape`` dict lets it resolve specs for any mesh without devices; both
packages resolve every parameter of all ten architectures, at smoke size
(the reference's own parameters and axes) and at full size (shapes from
the port's ``eval_params``, on the meta device), on meshes (1,1), (4,2),
(3,5), (16,16) and (2,16,16).
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.configs import ARCH_IDS, get_config as j_get_config  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import lm as jlm, whisper as jwhisper  # noqa: E402
from repro.train.optim import opt_state_axes as j_opt_state_axes  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding, specs  # noqa: E402
from repro_torch.models.common import resolve_hint  # noqa: E402
from repro_torch.train.optim import opt_state_axes  # noqa: E402

MESHES = {
    "1x1": {"data": 1, "model": 1},
    "4x2": {"data": 4, "model": 2},
    "3x5": {"data": 3, "model": 5},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def stand_in(sizes):
    """A mesh as both ``spec_for``s read it: ``shape`` (and the port's
    placements, ``mesh_dim_names``)."""
    return types.SimpleNamespace(shape=dict(sizes), mesh_dim_names=tuple(sizes))


@pytest.fixture(scope="module")
def smoke_reference():
    """arch -> (the reference's smoke parameters, their axes)."""
    out = {}
    for arch in ARCH_IDS:
        params, axes = jmodels.init(j_get_config(arch).smoke(), jax.random.PRNGKey(0))
        out[arch] = ({k: tuple(v.shape) for k, v in params.items()}, axes)
    return out


def test_rules_are_the_references():
    assert sharding.RULES == {k: list(v) for k, v in jsharding.RULES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_are_the_references(smoke_reference, arch):
    shapes, axes = smoke_reference[arch]
    cfg = get_config(arch).smoke()
    assert models.param_axes(cfg) == axes
    meta = models.meta_params(cfg)
    assert {k: tuple(v.shape) for k, v in meta.items()} == shapes
    assert all(v.device.type == "meta" for v in meta.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_opt_and_batch_axes_are_the_references(arch):
    cfg = get_config(arch)
    ref = (jwhisper if cfg.family == "audio" else jlm).decode_cache_axes(j_get_config(arch))
    assert models.decode_cache_axes(cfg) == ref
    axes = models.param_axes(cfg.smoke())
    assert opt_state_axes(axes) == j_opt_state_axes(axes)
    for shape in ("train_4k", "prefill_32k"):
        assert sharding.batch_axes_for(cfg, shape) == jsharding.batch_axes_for(j_get_config(arch), shape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_matches_the_reference(smoke_reference, arch, mesh):
    m = stand_in(MESHES[mesh])
    shapes, axes = smoke_reference[arch]
    full, full_axes = specs.eval_params(get_config(arch))
    cases = [(shape, axes[k]) for k, shape in shapes.items()]
    cases += [(tuple(v.shape), full_axes[k]) for k, v in full.items()]
    for shape, ax in cases:
        want = tuple(jsharding.spec_for(shape, ax, m))
        got = sharding.spec_for(shape, ax, m)
        assert got == want, (shape, ax, got, want)
        placements = sharding.placements_for(got, m)
        assert len(placements) == len(MESHES[mesh])


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    m = stand_in(MESHES["2x16x16"])
    assert sharding.placements_for((("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements_for((None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="expert"):
        sharding.placements_for(("expert",), m)


def test_hint_resolution_rule():
    """The reference's ``shard_hint`` rule: an axis only if the mesh has it
    and no earlier dim took it; leading axes dropped until the product
    divides the dim."""
    sizes = {"data": 4, "model": 2}
    assert resolve_hint((8, 6, 4), (("pod", "data"), "model", None), sizes) == ("data", "model", None)
    assert resolve_hint((6, 16), (("pod", "data"), "model"), sizes) == (None, "model")
    assert resolve_hint((8, 16, 16), ("model", "model", "data"), sizes) == ("model", None, "data")
    assert resolve_hint((8, 2), (("data", "model"), "model"), sizes) == (("data", "model"), None)
    assert resolve_hint((2, 3), (("data", "model"), "model"), sizes) == ("model", None)
