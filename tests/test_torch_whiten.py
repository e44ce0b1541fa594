"""Whitening in both packages: the host float64 learning functions
(``robust_cholesky``, ``whitenlearn``, ``pcawhitenlearn``) and the four
whiten stages on the same seeded numpy inputs. Learning is the same float64
numpy in both, so it must agree to 1e-12; applying a whitening is float32
in both (JAX at ``Precision.HIGHEST``, the port with TF32 off), so the
whitened rows must agree to 1e-6. The Lw retry on a non-positive-definite
covariance must draw the same random subsets from numpy's global RNG."""
import numpy as np
import pytest

import jax
import torch

from mdir_tpu.ops import whitening as jax_whitening
from mdir_tpu.stages import whiten as jax_stage

from mdir_tpu_torch.ops import whitening
from mdir_tpu_torch.stages import whiten as stage

LEARN_ATOL = 1e-12  # the same float64 numpy in both packages
APPLY_ATOL = 1e-6  # float32 products in both packages
D, N = 6, 50


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    names = ["n%d" % i for i in range(N)]
    values = rng.rand(N, D).astype(np.float32)
    return rng, names, values


def _learn_cases():
    rng = np.random.RandomState(1)
    X = rng.randn(D, 40)
    qidxs, pidxs = np.arange(0, 15), np.arange(15, 30)
    A = rng.randn(D, 3)
    singular = A @ A.T  # rank 3: needs the jitter
    return {
        "robust_cholesky": lambda mod: mod.robust_cholesky(X @ X.T / 40),
        "robust_cholesky_jitter": lambda mod: mod.robust_cholesky(singular),
        "whitenlearn": lambda mod: mod.whitenlearn(X, qidxs, pidxs),
        "pcawhitenlearn": lambda mod: mod.pcawhitenlearn(X),
        "pcawhitenlearn_shrink": lambda mod: mod.pcawhitenlearn(X, 3),
    }


@pytest.mark.parametrize("case", sorted(_learn_cases()))
def test_learning_matches_jax(case):
    fn = _learn_cases()[case]
    ours, theirs = fn(whitening), fn(jax_whitening)
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=0, atol=LEARN_ATOL)


def test_robust_cholesky_raises_past_its_jitter():
    with pytest.raises(np.linalg.LinAlgError):
        whitening.robust_cholesky(-np.eye(3) * 1e7)


def _stage_cases():
    rng, names, values = _data()
    whit = {"m": rng.rand(D, 1), "P": rng.rand(D, D)}
    return {
        "whiten": (lambda mod, **kw: mod.whiten(
            {"dimensions": 4}, (whit, names, values), **kw), True),
        "learn_lw_whitening": (lambda mod, **kw: mod.learn_lw_whitening(
            {}, (names, values, names[:20], names[20:40])), False),
        "learn_pca_whitening": (lambda mod, **kw: mod.learn_pca_whitening(
            {"shrink": 3}, (values.astype(np.float64),)), False),
        "paste_pca_normalize": (lambda mod, **kw: mod.paste_pca_normalize(
            {"dimensions": 3}, (values[:, :3], values[:, 3:])), False),
        "paste_normalize": (lambda mod, **kw: mod.paste_pca_normalize(
            {"dimensions": None}, (values[:, :3], values[:, 3:])), False),
    }


@pytest.mark.parametrize("case", sorted(_stage_cases()))
def test_stage_matches_jax(case):
    fn, on_device = _stage_cases()[case]
    ours = fn(stage, **({"device": "cpu"} if on_device else {}))
    theirs = fn(jax_stage)
    assert len(ours) == len(theirs)
    assert ours[0].keys() == theirs[0].keys()
    assert ours[0].get("stats") == theirs[0].get("stats")
    for a, b in zip(ours[1:], theirs[1:]):
        if isinstance(a, dict):
            assert a.keys() == b.keys() == {"m", "P"}
            for key in a:
                np.testing.assert_allclose(a[key], b[key], rtol=0,
                                           atol=LEARN_ATOL)
        elif isinstance(a, list):
            assert a == b
        else:
            b = np.asarray(b)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=APPLY_ATOL)


def test_whiten_stage_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, names, values = _data()
    whit = {"m": np.zeros((D, 1)), "P": np.eye(D)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage.whiten({}, (whit, names, values))


def _flaky(module, subsets, failures):
    real = module.whitenlearn

    def fn(vecs, qidxs, pidxs):
        subsets.append((np.asarray(qidxs).tolist(), np.asarray(pidxs).tolist()))
        if len(subsets) <= failures:
            raise np.linalg.LinAlgError("Matrix is not positive definite")
        return real(vecs, qidxs, pidxs)
    return fn


def test_lw_retry_matches_jax(monkeypatch):
    """The same non-PSD failures (two of them) and the same seed give the
    same subsets, the same ``failed_times`` and the same Lw."""
    _, names, values = _data()
    data = (names, values, names[:20], names[20:40])
    runs = []
    for module in (stage, jax_stage):
        subsets = []
        monkeypatch.setattr(module, "whitenlearn",
                            _flaky(module, subsets, failures=2))
        np.random.seed(0)
        metadata, lw = module.learn_lw_whitening({}, data)
        runs.append((subsets, metadata["stats"], lw))
    (ours, ours_stats, ours_lw), (theirs, theirs_stats, theirs_lw) = runs
    assert ours == theirs and len(ours) == 3
    assert len(ours[1][0]) < 20
    assert ours_stats == theirs_stats and ours_stats["failed_times"] == 2
    for key in ("m", "P"):
        np.testing.assert_allclose(ours_lw[key], theirs_lw[key], rtol=0,
                                   atol=LEARN_ATOL)


def test_lw_other_linalg_error_raises(monkeypatch):
    def hard_fail(vecs, qidxs, pidxs):
        raise np.linalg.LinAlgError("Singular matrix")

    _, names, values = _data()
    monkeypatch.setattr(stage, "whitenlearn", hard_fail)
    with pytest.raises(np.linalg.LinAlgError, match="Singular"):
        stage.learn_lw_whitening({}, (names, values, names[:20],
                                      names[20:40]))
