"""The port's copy of ModelDist against the JAX package's, byte for byte,
on the golden Child histogram. The full fit is not re-run here (it takes
minutes of host time and tests/test_parity_stage14.py already runs the JAX
one): the pieces it is made of are compared at fixed parameter points."""

import dataclasses
import gzip
import os

import numpy as np
import pytest

from rufus_tpu.models import modeldist as jmd
from rufus_tpu_torch.models import modeldist as pmd

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "Child.Jhash.histo.gz")


@pytest.fixture(scope="module")
def histo_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("md") / "Child.Jhash.histo"
    with gzip.open(GOLDEN, "rb") as f:
        p.write_bytes(f.read())
    return str(p)


def test_histo_round_trip_is_byte_identical(histo_path, tmp_path):
    want = jmd.read_histo(histo_path)
    got = pmd.read_histo(histo_path)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    counts = np.bincount(np.random.default_rng(0).integers(0, 12000, 5000))
    jmd.write_histo(str(tmp_path / "j"), counts)
    pmd.write_histo(str(tmp_path / "p"), counts)
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


@pytest.mark.parametrize("log_mode", [False, True])
@pytest.mark.parametrize("diploid", [True, False])
def test_test_model_at_parameter_points(histo_path, log_mode, diploid):
    histo, inflection, sc, *_ = pmd.read_histo(histo_path)
    err, _, _ = pmd.fit_error_model(histo.astype(np.float64), inflection)
    jerr, _, _ = jmd.fit_error_model(histo.astype(np.float64), inflection)
    np.testing.assert_array_equal(err, jerr)
    histo2 = np.where(histo - err > 0, histo - err, 0).astype(np.int64)
    for SC, stdev, factor, power in [(sc, 3.0, 1.0, 1.0),
                                     (sc * 1.05, 4.5, 2.5, 1.3),
                                     (sc * 0.93, 2.2, 7.0, 1.9)]:
        args = (SC, stdev, factor, 0.0, power, histo2, inflection, 5, 1.0)
        got = pmd._test_model(*args, log_mode=log_mode, diploid=diploid)
        want = jmd._test_model(*args, log_mode=log_mode, diploid=diploid)
        assert got == want or (np.isnan(got) and np.isnan(want))


def _fixed_fit(md, histo_path):
    """A ModelFit at fixed parameters, built from the module's own pieces
    exactly as fit_model's final-table step does."""
    histo, inflection, sc, _, histo_sum, *_ = md.read_histo(histo_path)
    size = len(histo)
    err, burner, _ = md.fit_error_model(histo.astype(np.float64), inflection)
    # a high peak keeps the copy-number columns (size / SC) few: the
    # writers format every cell in Python
    SC, stdev, factor, power = 150.7, 9.1, 1.7, 1.2
    dist, n_j = md._build_dist_cols(np.arange(size), size, SC, stdev, factor,
                                    0.0, power)
    for c in range(1, n_j + 1):
        dist[:, c] = dist[:, c] / dist[:, c].sum()
    prob = np.zeros((size + 1, n_j + 1))
    tot = dist[:, 1:n_j + 1].sum(axis=1)
    prob[1:, 1:n_j + 1] = dist[:, 1:n_j + 1] / tot[:, None]
    rc = np.linspace(0.0, 1e5, n_j + 1)
    model = dist[:, 1:n_j + 1] * rc[1:][None, :]
    return md.ModelFit(
        kcutoff=7, raw_sc=int(sc), histo_sum=histo_sum, sc=SC, stdev=stdev,
        factor=factor, skew=0.0, power=power, error_total=burner,
        error_model=err, error_dist=err / burner, rc=rc, dist_final=dist,
        prob_final=prob, model_final=model, model_sums=model.sum(axis=1),
        n_j=n_j, genome_size=1.0, raw_histo=histo)


@pytest.mark.parametrize("haploid", [False, True])
def test_write_outputs_is_byte_identical(histo_path, tmp_path, haploid):
    jfit = _fixed_fit(jmd, histo_path)
    pfit = _fixed_fit(pmd, histo_path)
    for f in dataclasses.fields(jfit):
        np.testing.assert_array_equal(getattr(pfit, f.name),
                                      getattr(jfit, f.name))
    jmd.write_outputs(jfit, str(tmp_path / "j"), haploid=haploid)
    pmd.write_outputs(pfit, str(tmp_path / "p"), haploid=haploid)
    prob = ".7.7boom.prob" if haploid else ".7.7.prob"
    for ext in (".7.7.model", ".7.7.dist", prob):
        want = (tmp_path / ("j" + ext)).read_bytes()
        assert (tmp_path / ("p" + ext)).read_bytes() == want, ext
