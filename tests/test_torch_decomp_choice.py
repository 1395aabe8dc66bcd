"""The randomized SVD's bucket choice, the port against the reference.

The reference takes the randomized SVD where the sketch ``max_bond +
rsvd_oversample`` is below a bucket's padded rank ``kp = min(rp, cp)``; the
port where it is below the rank of the stack it runs, the bucket trimmed to
its largest true sector, ``min(rmax, cmax)``
(``repro_torch.dist.decomp.DecompositionEngine._bucket_methods``).  Where
``min(rmax, cmax) <= sketch < kp`` the two differ: the sketch covers the
true rank, so both give the exact triplets, and the port's exact SVD of the
trimmed stack is the cheaper way there.  These tests build the same theta
from numpy in both packages and hold each package's choice, and the
values, against the other's.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.dist.decomp import DecompositionEngine as JaxDecomp  # noqa: E402
from repro.dist.plan import DecompPlanCache as JaxDecompCache  # noqa: E402
from repro.tensor import blocksparse as jbs  # noqa: E402
from repro.tensor import qn as jqn  # noqa: E402
from repro_torch.dist.decomp import DecompositionEngine  # noqa: E402
from repro_torch.dist.plan import DecompPlanCache  # noqa: E402
from repro_torch.tensor import blocksparse as tbs  # noqa: E402
from repro_torch.tensor import qn as tqn  # noqa: E402

IN, OUT = -1, 1


def theta_both(R, C, seed=0):
    """One sector of R x C with a decaying spectrum, in both packages."""
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((R, C)) * (0.7 ** np.arange(C))[None, :]
    j = jbs.BlockSparseTensor([jqn.Index((((0,), R),), IN), jqn.Index((((0,), C),), OUT)], {(0, 0): mat})
    t = tbs.BlockSparseTensor([tqn.Index((((0,), R),), IN), tqn.Index((((0,), C),), OUT)],
                              {(0, 0): torch.from_numpy(mat)})
    return j, t


def engines(method, **kw):
    return (JaxDecomp(JaxDecompCache(), method, jit=False, **kw), DecompositionEngine(DecompPlanCache(), method, **kw))


def choices(jeng, teng, jt, tt, max_bond):
    """Both packages' per-bucket methods, and the port's buckets."""
    jplan, tplan = jeng.cache.get(jt, 1), teng.cache.get(tt, 1)
    assert [(b.rp, b.cp) for b in jplan.buckets] == [(b.rp, b.cp) for b in tplan.buckets]
    want, _ = jeng._bucket_methods(jplan, max_bond)
    got, sketch = teng._bucket_methods(tplan, max_bond)
    return want, got, sketch, tplan.buckets


def assert_only_trimmed_rank_differs(want, got, sketch, buckets):
    """Every bucket chooses alike, except where the sketch covers the
    trimmed stack's rank but not the padded one: there the reference takes
    the randomized SVD and the port the exact one."""
    for w, g, b in zip(want, got, buckets):
        if w != g:
            assert (w, g) == ("rsvd", "svd"), (w, g)
            assert min(b.rmax, b.cmax) <= sketch < b.kp, (b.rmax, b.cmax, b.kp, sketch)


@pytest.mark.parametrize("max_bond", [5, 6, 7])
def test_roadmap_case_randomized_and_auto(max_bond):
    """One sector R=5, C=40 (padded to 8x64), no oversampling: under
    "randomized" the reference runs one randomized bucket and the port none,
    with equal truncation error and singular values; under "auto" each
    bucket's choice is held to the reference's."""
    jt, tt = theta_both(5, 40)
    jeng, teng = engines("randomized", rsvd_oversample=0)
    _, _, jsv, jerr = jeng.svd_split(jt, 1, max_bond, cutoff=0.0)
    _, _, tsv, terr = teng.svd_split(tt, 1, max_bond, cutoff=0.0)
    assert jeng.rsvd_buckets == 1 and teng.rsvd_buckets == 0
    assert abs(terr - jerr) <= 1e-12
    assert set(tsv) == set(jsv)
    for q in jsv:
        np.testing.assert_allclose(tsv[q].numpy(), np.asarray(jsv[q]), rtol=0, atol=1e-12)
    want, got, sketch, buckets = choices(jeng, teng, jt, tt, max_bond)
    assert (want, got) == (("rsvd",), ("svd",))
    assert_only_trimmed_rank_differs(want, got, sketch, buckets)
    want, got, sketch, buckets = choices(*engines("auto", rsvd_oversample=0), jt, tt, max_bond)
    assert_only_trimmed_rank_differs(want, got, sketch, buckets)
    assert want == got == ("svd",)  # the padded randomized SVD does not pay here


def test_auto_differs_exactly_on_the_trimmed_rank():
    """A bucket where the reference's cost model prices the randomized SVD
    cheaper (R=33, C=100, padded 64x128, no power iterations) while the
    sketch already covers the trimmed rank: the reference takes it, the port
    the exact SVD, and both give the same values."""
    jt, tt = theta_both(33, 100)
    kw = dict(rsvd_oversample=0, rsvd_power_iters=0)
    jeng, teng = engines("auto", **kw)
    want, got, sketch, buckets = choices(jeng, teng, jt, tt, 33)
    assert (want, got) == (("rsvd",), ("svd",))
    assert_only_trimmed_rank_differs(want, got, sketch, buckets)
    _, _, jsv, jerr = jeng.svd_split(jt, 1, 33, cutoff=0.0)
    _, _, tsv, terr = teng.svd_split(tt, 1, 33, cutoff=0.0)
    assert (jeng.rsvd_buckets, teng.rsvd_buckets) == (1, 0)
    assert abs(terr - jerr) <= 1e-12
    np.testing.assert_allclose(tsv[(0,)].numpy(), np.asarray(jsv[(0,)]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("max_bond", [8, 16, 24])
def test_auto_agrees_where_the_sketch_is_below_the_trimmed_rank(max_bond):
    """Below the trimmed rank both packages price the same padded bucket
    and choose alike."""
    jt, tt = theta_both(33, 100)
    want, got, sketch, buckets = choices(*engines("auto", rsvd_oversample=0, rsvd_power_iters=0), jt, tt, max_bond)
    assert sketch < min(b.rmax for b in buckets)
    assert want == got
