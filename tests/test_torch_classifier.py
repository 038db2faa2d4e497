"""The quality classifiers of the PyTorch port against the JAX package.

``stack_features`` (numpy on both sides: exact); ``predict_proba`` of a
``Classifier`` and a ``GtClassifier`` carried across from the JAX models'
parameters (``convert.classifier_from_arrays``), within 1e-6 (the port
computes in float32, the JAX package in float64 under its x64 mode); 50 Adam steps of ``train_classifier`` and
``train_gt_classifier`` from the JAX package's initial parameters, every
parameter within 1e-4 of optax's; both trainers separating a separable
world as ``tests/test_classifier.py`` asks; the ``.npz`` files saved by
either package loaded by the other (the same arrays, the port's in
float32, the probabilities within 1e-6); ``apply_to_vcf`` and ``gt_apply_to_vcf`` writing
the same VCF bytes, but for the ``##source=`` line, from the same
probabilities.
"""

import numpy as np
import jax
import pytest
import torch

from biograph_tpu.classifier import model as jmodel
from biograph_tpu.io import vcf as jvcf
from biograph_tpu_torch import convert
from biograph_tpu_torch.classifier import model as tmodel
from biograph_tpu_torch.io import vcf as tvcf


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small matmuls a training step: beside other test workers, more
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(rng, n, classes=2):
    """``tests/test_classifier.py``'s fake features, with a third class
    (hom) for the GT model, and some columns of the full feature set."""
    label = rng.integers(0, classes, n)
    alt = np.where(label > 0, rng.poisson(12 * label + 1, n), rng.poisson(3, n))
    ref = np.where(label < classes - 1, rng.poisson(25, n), rng.poisson(2, n))
    feats = {
        "alt_depth": alt,
        "ref_depth": ref,
        "alt_frac": (alt / np.maximum(alt + ref, 1)).astype(np.float32),
        "var_len": rng.integers(-5, 5, n),
        "is_snp": rng.integers(0, 2, n).astype(np.int8),
        "gq": np.where(label > 0, rng.poisson(60, n), rng.poisson(10, n)),
        "qual": rng.poisson(100, n).astype(float),
        "mc_alt": rng.random(n).astype(np.float32) * 30,
        "pl_het": rng.integers(0, 200, n).astype(np.int32),
    }
    return feats, label


def test_stack_features():
    feats, _ = _features(np.random.default_rng(1), 300)
    feats["var_len"][:5] = [-40, -1, 0, 1, 300]
    got, want = tmodel.stack_features(feats), jmodel.stack_features(feats)
    assert got.dtype == want.dtype == np.float32 and got.shape == (300, len(jmodel.FEATURES))
    np.testing.assert_array_equal(got, want)
    assert tmodel.FEATURES == jmodel.FEATURES and tmodel._LOG_FEATURES == jmodel._LOG_FEATURES
    assert tmodel.GT_CLASSES == jmodel.GT_CLASSES


def _jax_model(gt: bool, seed=3, hidden=32, n=400):
    """A JAX model with He-initialized weights and the normalization of a
    feature set, and those features."""
    feats, _ = _features(np.random.default_rng(seed), n, 3 if gt else 2)
    x = jmodel.stack_features(feats)
    out = 3 if gt else 1
    params = jmodel._init(jax.random.PRNGKey(seed), [x.shape[1], hidden, hidden, out])
    cls = jmodel.GtClassifier if gt else jmodel.Classifier
    return cls(params=params, mean=x.mean(axis=0), std=x.std(axis=0) + 1e-6), feats


def _arrays(clf):
    return {k: np.asarray(v) for k, v in clf.params.items()} | {"mean": clf.mean, "std": clf.std}


@pytest.mark.parametrize("gt", [False, True], ids=["qual", "gt"])
def test_predict_proba_with_carried_weights(gt):
    jclf, feats = _jax_model(gt)
    tclf = convert.classifier_from_arrays(_arrays(jclf), "cpu")
    assert isinstance(tclf, tmodel.GtClassifier if gt else tmodel.Classifier)
    assert [tuple(layer.weight.shape) for layer in tclf.layers] == [(32, 28), (32, 32), (3 if gt else 1, 32)]
    got, want = tclf.predict_proba(feats), jclf.predict_proba(feats)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if gt:
        np.testing.assert_array_equal(tclf.predict(feats), jclf.predict(feats))
    for k, v in _arrays(jclf).items():  # the weights come back in the JAX layout
        np.testing.assert_array_equal(tclf.params[k] if k[0] in "wb" else getattr(tclf, k), v.astype(np.float32))


@pytest.mark.parametrize("gt", [False, True], ids=["qual", "gt"])
def test_adam_steps_from_a_carried_init_follow_optax(gt):
    feats, labels = _features(np.random.default_rng(7), 500, 3 if gt else 2)
    n_feat = len(jmodel.FEATURES)
    sizes = [n_feat, 32, 32, 3 if gt else 1]
    init = {k: np.asarray(v) for k, v in jmodel._init(jax.random.PRNGKey(0), sizes).items()}
    if gt:
        want = jmodel.train_gt_classifier(feats, labels, steps=50, seed=0)
        got = tmodel.train_gt_classifier(feats, labels, steps=50, device="cpu", init=init)
    else:
        want = jmodel.train_classifier(feats, labels > 0, steps=50, seed=0)
        got = tmodel.train_classifier(feats, labels > 0, steps=50, device="cpu", init=init)
    np.testing.assert_array_equal(got.mean, want.mean)
    np.testing.assert_array_equal(got.std, want.std)
    moved = 0.0
    for k, v in want.params.items():
        np.testing.assert_allclose(got.params[k], np.asarray(v), rtol=0, atol=1e-4, err_msg=k)
        moved = max(moved, float(np.abs(np.asarray(v) - init[k]).max()))
    assert moved > 0.1  # the steps moved the weights far past the tolerance
    np.testing.assert_allclose(got.predict_proba(feats), want.predict_proba(feats), rtol=0, atol=1e-4)


def test_train_and_separate():
    """``tests/test_classifier.py``'s bar on the port: accuracy above 0.95
    on a separable world, for the QUAL model and the GT model; the init
    drawn from the seed is the same at every call."""
    rng = np.random.default_rng(12345)
    feats, labels = _features(rng, 2000)
    clf = tmodel.train_classifier(feats, labels > 0, steps=600, device="cpu")
    assert ((clf.predict_proba(feats) > 0.5) == (labels > 0)).mean() > 0.95
    feats3, labels3 = _features(rng, 2000, 3)
    gclf = tmodel.train_gt_classifier(feats3, labels3, steps=600, device="cpu")
    assert (gclf.predict(feats3) == labels3).mean() > 0.95
    a, b = tmodel.init_params(0, [4, 3, 1]), tmodel.init_params(0, [4, 3, 1])
    assert all(np.array_equal(a[k], b[k]) for k in a) and not np.array_equal(a["w0"], tmodel.init_params(1, [4, 3, 1])["w0"])


@pytest.mark.parametrize("gt", [False, True], ids=["qual", "gt"])
def test_npz_both_ways(gt, tmp_path):
    jclf, feats = _jax_model(gt, seed=5)
    jcls, tcls = (jmodel.GtClassifier, tmodel.GtClassifier) if gt else (jmodel.Classifier, tmodel.Classifier)
    jclf.save(str(tmp_path / "j.npz"))
    tclf = tcls.load(str(tmp_path / "j.npz"), device="cpu")
    np.testing.assert_allclose(tclf.predict_proba(feats), jclf.predict_proba(feats), rtol=0, atol=1e-6)
    tclf.save(str(tmp_path / "t.npz"))
    jback = jcls.load(str(tmp_path / "t.npz"))
    z_j, z_t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(z_j.files) == sorted(z_t.files)
    for k in z_j.files:
        assert z_t[k].dtype == (np.float32 if k[0] in "wbms" else z_j[k].dtype) and z_t[k].shape == z_j[k].shape, k
        np.testing.assert_array_equal(z_t[k], z_j[k].astype(z_t[k].dtype), err_msg=k)
    np.testing.assert_allclose(jback.predict_proba(feats), tclf.predict_proba(feats), rtol=0, atol=1e-6)
    if gt:
        with pytest.raises(ValueError, match="not a gt_classifier"):
            tmodel.GtClassifier.load(_qual_file(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcls.load(str(tmp_path / "t.npz"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmodel.train_classifier(feats, np.ones(len(feats["gq"]), bool), steps=1)


def _qual_file(tmp_path):
    jclf, _ = _jax_model(False, seed=5)
    jclf.save(str(tmp_path / "qual.npz"))
    return str(tmp_path / "qual.npz")


class _Fixed:
    """A classifier stand-in that returns the given probabilities."""

    def __init__(self, prob):
        self.prob = prob

    def predict_proba(self, feats):
        return self.prob


@pytest.mark.parametrize("gt", [False, True], ids=["qual", "gt"])
def test_apply_to_vcf_bytes(gt, tmp_path):
    rng = np.random.default_rng(9)
    n = 40
    with tvcf.VcfWriter(str(tmp_path / "in.vcf"), sample="S1", contigs=[("chr1", 10_000)]) as w:
        for i in range(n):
            w.write(tvcf.VcfRecord("chr1", 100 * i + 1, "A", "C", qual=float(i), info={"DP": i}, fmt={"GT": "0/1", "DP": i}))
    if gt:
        prob = rng.dirichlet([1, 1, 1], n).astype(np.float32)
        prob[0] = [1, 0, 0]
        prob[1] = [0.5, 0.5, 0]
        args = lambda m: (m.gt_apply_to_vcf, _Fixed(prob), str(tmp_path / "in.vcf"))
    else:
        prob = rng.random(n).astype(np.float32)
        prob[:4] = [0.0, 1.0, 0.5, np.nextafter(np.float32(0.5), np.float32(0))]
        args = lambda m: (m.apply_to_vcf, _Fixed(prob), str(tmp_path / "in.vcf"))
    fn, clf, vcf_in = args(jmodel)
    want = fn(clf, vcf_in, str(tmp_path / "j.vcf"), {}, sample="S1")
    fn, clf, vcf_in = args(tmodel)
    got = fn(clf, vcf_in, str(tmp_path / "t.vcf"), {}, sample="S1")
    np.testing.assert_array_equal(got, want)
    jtext, ttext = (tmp_path / "j.vcf").read_text(), (tmp_path / "t.vcf").read_text()
    assert ttext.replace("##source=biograph_tpu_torch\n", "##source=biograph_tpu\n") == jtext
    assert ("lowq" in ttext and "PASS" in ttext) if not gt else "GQ" in ttext
    np.testing.assert_array_equal(tmodel._phred(prob), jmodel._phred(prob))
    with pytest.raises(ValueError, match="feature rows"):
        fn(_Fixed(prob[:-1]), vcf_in, str(tmp_path / "x.vcf"), {})
