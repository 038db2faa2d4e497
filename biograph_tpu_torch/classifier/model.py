"""Variant quality classifier: a small MLP in torch.

Counterpart of ``biograph_tpu/classifier/model.py``: the same feature
matrix in (``stack_features``, numpy), the same three dense layers
``[n_features, hidden, hidden, out]`` with ReLU between them, a sigmoid (the
QUAL model) or a softmax over REF/HET/HOM (the GT model) out, trained with
Adam on the whole call set at once.  ``Classifier`` and ``GtClassifier`` are
``nn.Module``s whose parameters live on a chosen device.

The weights carry across both ways: ``save`` writes the JAX package's
``.npz`` layout (``w0..w2`` as ``[in, out]``, ``b0..b2``, ``mean``, ``std``,
and ``gt_model`` for the GT model), so a model saved by either package loads
in the other, and ``convert.classifier_from_arrays`` takes a JAX model's
parameters as numpy arrays.  ``train_*`` draw the He init from a
``torch.Generator(seed)``, which cannot reproduce JAX's draws; given the
same initial arrays (``init=``) they follow optax's Adam (same b1, b2, eps
and bias correction) step for step, up to rounding.  The port computes in
float32, at full precision (PyTorch's default: TF32 off); the JAX package
computes in float64, since it turns on JAX's x64 mode, and saves float64
weights, which load here as float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from biograph_tpu_torch import resolve_device

FEATURES = [
    "alt_depth", "ref_depth", "alt_frac", "var_len", "is_snp", "gq", "qual",
    "pair_cov",
    # flank and ratio evidence; absent in older feature files -> zeros
    "us_alt", "ds_alt", "us_ref", "ds_ref", "ad_ratio",
    # variant shape, window shape per allele, GC context, PL columns
    "var_type", "abs_var_len", "refspan", "asmlen",
    "xc_alt", "mc_alt", "ec_alt", "xc_ref", "mc_ref", "ec_ref",
    "gc_alt", "gc_ref", "pl_ref", "pl_het", "pl_hom",
]

_LOG_FEATURES = frozenset(
    (
        "alt_depth", "ref_depth", "gq", "qual", "pair_cov",
        "us_alt", "ds_alt", "us_ref", "ds_ref",
        "abs_var_len", "refspan", "asmlen",
        "xc_alt", "mc_alt", "ec_alt", "xc_ref", "mc_ref", "ec_ref",
        "pl_ref", "pl_het", "pl_hom",
    )
)

GT_CLASSES = ("0/0", "0/1", "1/1")
BCE_EPS = 1e-7


def stack_features(feats: Dict[str, np.ndarray]) -> np.ndarray:
    """float32 [n, len(FEATURES)]: counts log1p'd, var_len sign-log'd,
    missing columns zero."""
    n = len(np.asarray(next(iter(feats.values()))))
    cols = []
    for name in FEATURES:
        if name in feats:
            col = np.asarray(feats[name], np.float32)
        else:
            col = np.zeros(n, np.float32)
        if name in _LOG_FEATURES:
            col = np.log1p(np.maximum(col, 0))
        if name == "var_len":
            col = np.sign(col) * np.log1p(np.abs(col))
        cols.append(col)
    return np.stack(cols, axis=1)


def init_params(seed: int, sizes) -> Dict[str, np.ndarray]:
    """He-initialized ``{w_i [a, b], b_i [b]}`` float32 arrays for layer
    sizes ``[n_features, hidden, ..., out]``, from ``torch.Generator(seed)``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = (torch.randn((a, b), generator=g) * np.sqrt(2.0 / a)).numpy()
        params[f"b{i}"] = np.zeros(b, np.float32)
    return params


class _MLP(nn.Module):
    """Dense layers from ``{w_i [in, out], b_i}`` arrays, on ``device``,
    with the feature normalization (``mean``, ``std``, host float32)."""

    def __init__(self, params: Dict[str, np.ndarray], mean, std, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        n_layers = len([k for k in params if k.startswith("w")])
        self.layers = nn.ModuleList()
        for i in range(n_layers):
            w = np.asarray(params[f"w{i}"], np.float32)
            layer = nn.Linear(w.shape[0], w.shape[1], device=dev)
            with torch.no_grad():
                layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
                layer.bias.copy_(torch.from_numpy(np.asarray(params[f"b{i}"], np.float32)))
            self.layers.append(layer)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    @property
    def device(self) -> torch.device:
        return self.layers[0].weight.device

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)

    def _normalized(self, feats) -> torch.Tensor:
        x = (stack_features(feats) - self.mean) / self.std
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    @torch.no_grad()
    def predict_proba(self, feats: Dict[str, np.ndarray]) -> np.ndarray:
        """float32 probabilities: [n] for the QUAL model, [n, 3] for the GT
        model."""
        return self(self._normalized(feats)).cpu().numpy()

    @property
    def params(self) -> Dict[str, np.ndarray]:
        """The weights in the JAX package's layout: ``w_i`` as [in, out]."""
        out = {}
        for i, layer in enumerate(self.layers):
            out[f"w{i}"] = layer.weight.detach().cpu().numpy().T.copy()
            out[f"b{i}"] = layer.bias.detach().cpu().numpy().copy()
        return out

    def _save(self, path: str, **extra):
        np.savez(path, mean=self.mean, std=self.std, **extra, **self.params)

    @staticmethod
    def _arrays(path: str):
        z = np.load(path)
        params = {k: z[k] for k in z.files if k[0] in "wb"}
        return z, params


class Classifier(_MLP):
    """The QUAL model: probability that a record is a true variant."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.logits(x)[:, 0])

    def save(self, path: str):
        self._save(path)

    @staticmethod
    def load(path: str, device="cuda") -> "Classifier":
        z, params = _MLP._arrays(path)
        return Classifier(params, z["mean"], z["std"], device)


class GtClassifier(_MLP):
    """The 3-class genotype model (REF/HET/HOM) over the same features."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.logits(x), dim=-1)

    def predict(self, feats: Dict[str, np.ndarray]) -> np.ndarray:
        return self.predict_proba(feats).argmax(axis=1)

    def save(self, path: str):
        self._save(path, gt_model=True)

    @staticmethod
    def load(path: str, device="cuda") -> "GtClassifier":
        z, params = _MLP._arrays(path)
        if "gt_model" not in z.files:
            raise ValueError(f"{path}: not a gt_classifier model")
        return GtClassifier(params, z["mean"], z["std"], device)


def _fit(model: _MLP, loss_fn, steps: int, lr: float):
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model)
        loss.backward()
        opt.step()
    return model


def _prepared(feats, device):
    x = stack_features(feats)
    mean = x.mean(axis=0)
    std = x.std(axis=0) + 1e-6
    xn = torch.from_numpy(np.ascontiguousarray((x - mean) / std, np.float32)).to(device)
    return x.shape[1], mean, std, xn


def train_classifier(
    feats: Dict[str, np.ndarray],
    labels: np.ndarray,
    hidden: int = 32,
    steps: int = 2000,
    lr: float = 1e-2,
    seed: int = 0,
    device="cuda",
    init: Dict[str, np.ndarray] | None = None,
) -> Classifier:
    """Fit the QUAL model on (features, bool labels) with Adam on the whole
    set each step; ``init`` gives the initial ``{w_i, b_i}`` arrays in place
    of the draw from ``seed``."""
    dev = resolve_device(device)
    n_feat, mean, std, xn = _prepared(feats, dev)
    y = torch.from_numpy(np.asarray(labels, np.float32)).to(dev)
    params = init if init is not None else init_params(seed, [n_feat, hidden, hidden, 1])
    model = Classifier(params, mean, std, dev)

    def bce(m):
        prob = m(xn)
        return -torch.mean(y * torch.log(prob + BCE_EPS) + (1 - y) * torch.log(1 - prob + BCE_EPS))

    return _fit(model, bce, steps, lr)


def train_gt_classifier(
    feats: Dict[str, np.ndarray],
    gt_labels: np.ndarray,
    hidden: int = 32,
    steps: int = 2000,
    lr: float = 1e-2,
    seed: int = 0,
    device="cuda",
    init: Dict[str, np.ndarray] | None = None,
) -> GtClassifier:
    """Fit the 3-class GT model; gt_labels are ints (0=0/0, 1=0/1, 2=1/1)."""
    dev = resolve_device(device)
    n_feat, mean, std, xn = _prepared(feats, dev)
    y = torch.from_numpy(np.asarray(gt_labels, np.int64)).to(dev)
    params = init if init is not None else init_params(seed, [n_feat, hidden, hidden, len(GT_CLASSES)])
    model = GtClassifier(params, mean, std, dev)

    def nll(m):
        lp = torch.log_softmax(m.logits(xn), dim=-1)
        return -torch.mean(torch.gather(lp, 1, y[:, None]))

    return _fit(model, nll, steps, lr)


def _phred(p: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        r = -10.0 * np.log10(np.maximum(p, 0.0))
    return np.minimum(np.round(np.nan_to_num(r, posinf=99.0)), 99).astype(int)


def gt_apply_to_vcf(clf: GtClassifier, vcf_in: str, vcf_out: str, feats: Dict[str, np.ndarray], sample: str = "SAMPLE"):
    """Re-genotype a VCF from the GT model: GT the argmax class, PL the phred
    of each class's probability capped at 99, GQ the second-best PL less the
    best."""
    from biograph_tpu_torch.io.vcf import VcfWriter, read_vcf

    records = read_vcf(vcf_in)
    proba = clf.predict_proba(feats)
    if len(proba) != len(records):
        raise ValueError(f"{len(proba)} feature rows for {len(records)} records")
    pl = _phred(proba)
    srt = np.sort(pl, axis=1)
    gq = srt[:, 1] - srt[:, 0]
    cls = proba.argmax(axis=1)
    headers = [
        '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
    ]
    with VcfWriter(vcf_out, sample=sample, extra_headers=headers) as w:
        for i, rec in enumerate(records):
            rec.fmt["GT"] = GT_CLASSES[int(cls[i])]
            rec.fmt["GQ"] = int(gq[i])
            rec.fmt["PL"] = ",".join(str(int(v)) for v in pl[i])
            w.write(rec)
    return cls


def apply_to_vcf(
    clf: Classifier,
    vcf_in: str,
    vcf_out: str,
    feats: Dict[str, np.ndarray],
    min_prob: float = 0.5,
    sample: str = "SAMPLE",
):
    """Rewrite QUAL and FILTER from the classifier's probabilities: QUAL the
    phred of 1 - p, FILTER PASS at p >= min_prob, else lowq."""
    from biograph_tpu_torch.io.vcf import VcfWriter, read_vcf

    records = read_vcf(vcf_in)
    prob = clf.predict_proba(feats)
    if len(prob) != len(records):
        raise ValueError(f"{len(prob)} feature rows for {len(records)} records")
    with VcfWriter(vcf_out, sample=sample) as w:
        for rec, p in zip(records, prob):
            rec.qual = max(round(float(-10 * np.log10(max(1 - p, 1e-10))), 1), 0.0)
            rec.filter = "PASS" if p >= min_prob else "lowq"
            w.write(rec)
    return prob
