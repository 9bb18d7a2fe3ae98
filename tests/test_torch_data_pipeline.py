"""The port's data pipeline against the JAX package's on the CPU: the
surrogate data sets of the paper's accuracy tables (bit for bit),
``doc_sketch`` (rtol 1e-6: the counts are exact, the norms may differ in
the last bit), ``ClusterBalancedSampler`` with the randomness-free spec
(``init="landmark"`` in both stages, ``tol=0``; assignment, clusters,
draws and batches equal to the reference's), its determinism in (seed,
step), its cluster-uniform draws, and the paper's Table 1 bound through
the port's sampled k-means (on the mean over eight seeds).

The sampler's corpus is built from a few topics (each document draws
most of its tokens from its topic's six), so its sketches cluster and the
landmark fit is well conditioned: the exact comparison holds only where
no assignment sits at a near-tie (ROADMAP.md §3)."""
import numpy as np
import pytest
import torch

from repro.core import ClusterSpec as JSpec
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro_torch.core import (ClusterSpec, relative_error, sampled_kmeans,
                              standard_kmeans)
from repro_torch.data import (ClusterBalancedSampler, doc_sketch,
                              surrogate_iris, surrogate_seeds)


def _corpus(n=1024, seq=33, topics=8, seed=0):
    rng = np.random.default_rng(seed)
    topic = rng.integers(0, topics, n)
    words = rng.integers(0, 50_000, (topics, 6))
    pick = words[topic[:, None], rng.integers(0, 6, (n, seq))]
    noise = rng.random((n, seq)) < 0.2
    return np.where(noise, rng.integers(0, 50_000, (n, seq)),
                    pick).astype(np.int32)


def _landmark(cls):
    return cls.make(8, n_sub=4, compression=4, init="landmark", restarts=1)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", ["iris", "seeds"])
def test_surrogates_equal_the_reference(name, seed):
    port = {"iris": surrogate_iris, "seeds": surrogate_seeds}[name]
    ref = {"iris": jsynthetic.surrogate_iris,
           "seeds": jsynthetic.surrogate_seeds}[name]
    (x, y), (jx, jy) = port(seed), ref(seed)
    assert x.dtype == jx.dtype == np.float32
    assert x.shape == {"iris": (150, 4), "seeds": (210, 7)}[name]
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("dim", [16, 32])
def test_doc_sketch_matches_the_reference(dim):
    docs = np.random.default_rng(dim).integers(0, 128_256, (300, 65)
                                               ).astype(np.int32)
    want = jpipeline.doc_sketch(docs, dim)
    got = doc_sketch(docs, dim, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (300, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def landmark_pair():
    docs = _corpus()
    return (docs,
            jpipeline.ClusterBalancedSampler(docs, spec=_landmark(JSpec),
                                             seed=0),
            ClusterBalancedSampler(docs, spec=_landmark(ClusterSpec), seed=0,
                                   device="cpu"))


def test_landmark_sampler_assignment_equals_the_reference(landmark_pair):
    _, ref, port = landmark_pair
    assert port.assignment.dtype == np.int32
    np.testing.assert_array_equal(port.assignment, ref.assignment)
    assert port.n_clusters == ref.n_clusters == 8
    assert len(port.by_cluster) == len(ref.by_cluster) >= 3
    for got, want in zip(port.by_cluster, ref.by_cluster):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("step", [0, 3, 1000])
def test_landmark_sampler_draws_equal_the_reference(landmark_pair, step):
    _, ref, port = landmark_pair
    np.testing.assert_array_equal(port.batch_indices(step, 64),
                                  ref.batch_indices(step, 64))
    got, want = port.batch(step, 8, 16), ref.batch(step, 8, 16)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == np.int32 and got[k].shape == (8, 16)
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["labels"][:, :-1])


def test_sampler_is_deterministic_in_seed_and_step():
    """Two samplers of one seed (kmeans++ in both stages) fit the same
    clusters and draw the same batches; another step draws another."""
    docs = _corpus(seed=3)
    s1 = ClusterBalancedSampler(docs, n_clusters=4, n_sub=4, seed=1,
                                device="cpu")
    s2 = ClusterBalancedSampler(docs, n_clusters=4, n_sub=4, seed=1,
                                device="cpu")
    np.testing.assert_array_equal(s1.assignment, s2.assignment)
    assert torch.equal(s1.centers, s2.centers)
    b1, b2 = s1.batch(5, 8, 32), s2.batch(5, 8, 32)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(s1.batch_indices(5, 64),
                              s1.batch_indices(6, 64))
    assert s1.n_clusters == 4


def test_default_sampler_has_16_clusters():
    s = ClusterBalancedSampler(_corpus(seed=4), device="cpu")
    assert s.n_clusters == 16 and s.centers.shape == (16, 32)
    assert sum(len(ids) for ids in s.by_cluster) == 1024


def test_sampler_draws_clusters_uniformly(landmark_pair):
    """Chi-square over the clusters of 8192 drawn documents: p > 1e-3."""
    _, _, port = landmark_pair
    ids = port.batch_indices(11, 8192)
    sizes = np.bincount(port.assignment, minlength=port.n_clusters)
    drawn = np.bincount(port.assignment[ids], minlength=port.n_clusters)
    live = drawn[sizes > 0]
    expected = len(ids) / len(port.by_cluster)
    stat = float(((live - expected) ** 2 / expected).sum())
    p = float(torch.special.gammaincc(
        torch.tensor((len(live) - 1) / 2, dtype=torch.float64),
        torch.tensor(stat / 2, dtype=torch.float64)))
    assert len(live) == len(port.by_cluster) and p > 1e-3, (drawn, p)


def test_n_clusters_disagreeing_with_the_spec_raises():
    docs = _corpus(n=64)
    with pytest.raises(ValueError, match="spec.merge.k"):
        ClusterBalancedSampler(docs, n_clusters=5,
                               spec=ClusterSpec.make(4, n_sub=2),
                               device="cpu")
    with pytest.raises(ValueError, match="spec.merge.k"):
        jpipeline.ClusterBalancedSampler(docs, n_clusters=5,
                                         spec=JSpec.make(4, n_sub=2))


TABLE1_SEEDS = range(8)
# each seed's error: about 1.5x the largest sound reading (0.167 here,
# 0.170 on the H100, iris with the equal scheme)
TABLE1_WORST_MAX = 0.25


@pytest.mark.parametrize("scheme", ["equal", "unequal"])
@pytest.mark.parametrize("dataset", ["iris", "seeds"])
def test_paper_table1_accuracy_through_the_port(dataset, scheme):
    """Paper Table 1 (``tests/test_system.py``'s bound of 0.12): 6
    subclusters, 6x compression; the sampled SSE's relative error against
    standard k-means', averaged over the seeds 0-7.  One seed's error is
    one draw of the fit's random stages: on iris with the equal scheme the
    reference reads 0.133 at its key 1 and the port 0.126 at its seed 0,
    while both average 0.09 over the eight.  Each seed's error is also
    bounded, at ``TABLE1_WORST_MAX``, so that a shift of the distribution
    fails even where the mean stays under 0.12."""
    x, _ = surrogate_iris() if dataset == "iris" else surrogate_seeds()
    full = standard_kmeans(x, 3, iters=40, device="cpu")
    spec = ClusterSpec.make(3, scheme=scheme, n_sub=6, compression=6)
    rels = [relative_error(float(sampled_kmeans(x, 3, spec=spec, seed=seed,
                                                device="cpu").sse),
                           float(full.sse)) for seed in TABLE1_SEEDS]
    assert np.mean(rels) < 0.12, (dataset, scheme, rels)
    assert max(rels) < TABLE1_WORST_MAX, (dataset, scheme, rels)
