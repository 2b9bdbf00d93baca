"""The port's analytical side against the JAX package's: the Table II PPA
model, the accuracy-PPA sweep, the composed-error sensitivity model and the
per-layer auto-configurer, and the two bench drivers (on the CPU, small).

- ``ppa.estimate`` equals the JAX model on every Table II row, exactly
  (the same Python arithmetic);
- ``probe_gain`` and the ``sensitivity`` block of
  ``tests/golden/policy_golden.json`` agree within 1e-5 relative (gains,
  alpha, out_rms, tail) and 1e-3 (local errors, as the reference's own
  golden test holds them);
- ``auto_configure`` (proxy at three budgets, greedy at one) on the same
  ResNet and calibration batch emits the JAX package's assignments;
- the policy roll-ups (``ppa_report``, ``policy_compute_scale``) are equal.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ppa as jax_ppa
from repro.core import sensitivity as jax_sens
from repro.core import sweep as jax_sweep
from repro.core.numerics import NumericsConfig as JaxConfig
from repro.core.policy import NumericsPolicy as JaxPolicy
from repro.launch import hlo_analysis as jax_hlo
from repro.models import resnet as jr
from repro.models.layers import unzip
from repro.session import Session as JaxSession
from repro_torch.compat import params_from_numpy, resnet_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core import ppa, sensitivity, sweep
from repro_torch.core.numerics import NumericsConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.launch import hlo_analysis
from repro_torch.models import resnet
from repro_torch.numerics import layer_scope, nmatmul, numerics_scope
from repro_torch.session import Session

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "policy_golden.json")
QWEN_FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "compat",
                            "qwen3-4b")
EXACT_F32 = NumericsConfig(mode="exact", compute_dtype="float32")


@pytest.mark.parametrize("name", list(jax_ppa.TABLE2_SPECS))
def test_ppa_estimate_equals_jax_on_every_table2_row(name):
    kind, kw = ppa.TABLE2_SPECS[name]
    assert (kind, kw) == jax_ppa.TABLE2_SPECS[name]
    assert dataclasses.asdict(ppa.estimate(kind, name=name, **kw)) == \
        dataclasses.asdict(jax_ppa.estimate(kind, name=name, **kw))
    assert ppa.PAPER_TABLE2_64x32[name] == jax_ppa.PAPER_TABLE2_64x32[name]


def test_ppa_constants_and_claims_equal_jax():
    assert ppa.PAPER_CLAIMS == jax_ppa.PAPER_CLAIMS
    assert ppa.bd_omission_savings(5) == jax_ppa.bd_omission_savings(5)
    assert ppa.multiplier_ge("mmbs", k=6) == jax_ppa.multiplier_ge("mmbs", k=6)
    assert sweep.SWEEPABLE == jax_sweep.SWEEPABLE
    with pytest.raises(ValueError):
        ppa.multiplier_ge("wallace")


def test_sweep_and_recommend_match_jax():
    mine = sweep.sweep(n_samples=3000, device="cpu")
    ref = jax_sweep.sweep(n_samples=3000)
    assert [p.name for p in mine] == [p.name for p in ref]
    for a, b in zip(mine, ref):
        assert (a.area_um2, a.power_w, a.pareto) == \
            (b.area_um2, b.power_w, b.pareto), a.name
        assert a.mred == pytest.approx(b.mred, rel=1e-12), a.name
    assert sweep.recommend(1e-3, n_samples=3000, device="cpu").name == \
        jax_sweep.recommend(1e-3, n_samples=3000).name
    assert [n for n, _ in sweep.pareto_candidates(n_samples=3000,
                                                  device="cpu")] == \
        [n for n, _ in jax_sweep.pareto_candidates(n_samples=3000)]


@pytest.mark.parametrize("method", ["jvp", "fd"])
def test_probe_gain_matches_jax(method, rng):
    x = rng.standard_normal((12, 8)).astype(np.float32)
    w = (rng.standard_normal((8, 6)) * 0.4).astype(np.float32)
    assert sensitivity.probe_gain(x, w, method) == pytest.approx(
        jax_sens.probe_gain(x, w, method), rel=1e-5)


def test_sensitivity_coefficients_match_golden():
    """The reference's golden test, run through the port's operand tap."""
    with open(GOLDEN) as f:
        gold = json.load(f)["sensitivity"]
    pol = sensitivity.calibration_policy(EXACT_F32)
    with sensitivity.record_operands() as store:
        with numerics_scope(pol):
            for site in gold["sites"]:
                with layer_scope(site["path"]):
                    nmatmul(torch.tensor(site["x"], dtype=torch.float32),
                            torch.tensor(site["w"], dtype=torch.float32))
    model = sensitivity.SensitivityModel.from_store(store)
    seg = {f"seg{p}": NumericsConfig(mode="segmented", seg_passes=p)
           for p in (1, 2, 3)}
    assert model.tail == pytest.approx(gold["tail_factor"], rel=1e-5)
    for site in gold["sites"]:
        p = site["path"]
        assert model.sites[p].out_rms == pytest.approx(site["out_rms"],
                                                       rel=1e-5)
        assert model.sites[p].chained == site["chained"]
        assert model.sites[p].gain == pytest.approx(site["site_gain"],
                                                    rel=1e-5)
        assert model.alpha[p] == pytest.approx(site["alpha"], rel=1e-5)
        assert model.gain[p] == pytest.approx(site["downstream_gain"],
                                              rel=1e-5)
        for tag, want in site["local_mred"].items():
            assert model.local_error(p, seg[tag]) == pytest.approx(
                want, rel=1e-3), (p, tag)
        for tag, want in site["local_rms"].items():
            assert model.local_rms_error(p, seg[tag]) == pytest.approx(
                want, rel=1e-3), (p, tag)
    composed = model.predict(
        {p: seg[tag] for p, tag in gold["assignment"].items()})
    assert composed == pytest.approx(gold["composed_prediction"], rel=1e-3)


@pytest.fixture(scope="module")
def resnet_pair():
    """A JAX ResNet session and the port's over the same weights, with a
    calibration batch (the reference's own calibration widths)."""
    widths = (8, 16, 32, 64)
    cfg = jr.ResNetConfig(widths=widths)
    pp, state = jr.init(cfg, jax.random.PRNGKey(0))
    params, _ = unzip(pp)
    mine_cfg = resnet.ResNetConfig(widths=widths)
    tp, ts = resnet_from_numpy(jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, state), mine_cfg,
                               "cpu")
    images = np.random.default_rng(0).standard_normal(
        (4, 16, 16, 3)).astype(np.float32)
    return (JaxSession.from_resnet(cfg, params, state),
            Session.from_resnet(mine_cfg, tp, ts, device="cpu"), images)


@pytest.mark.parametrize("budget", [3e-4, 1e-3, 3e-2])
def test_proxy_auto_configure_emits_jax_assignments(budget, resnet_pair):
    js, ts, images = resnet_pair
    want = js.replace(policy=None).auto_configure(budget,
                                                  calib=jnp.asarray(images))
    got = ts.replace(policy=None).auto_configure(budget, calib=images)
    assert got.method == "proxy" and got.n_evals == 1
    assert got.assignments == want.assignments
    # the composed error sums local errors measured against each package's
    # own fp32 product: segmented-3's (about 5e-6 of a site's rms) is
    # within 50x of the two packages' fp32 sum-order difference
    assert got.error == pytest.approx(want.error, rel=5e-2)
    assert (got.area_um2, got.baseline_area_um2) == \
        (want.area_um2, want.baseline_area_um2)


def test_greedy_auto_configure_emits_jax_assignments():
    """Greedy re-measures the network per candidate: a one-block-a-stage
    net keeps the reference's evaluations few."""
    cfg = jr.ResNetConfig(widths=(8, 16), blocks=(1, 1))
    pp, state = jr.init(cfg, jax.random.PRNGKey(1))
    params, _ = unzip(pp)
    mine_cfg = resnet.ResNetConfig(widths=(8, 16), blocks=(1, 1))
    tp, ts = resnet_from_numpy(jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, state), mine_cfg,
                               "cpu")
    images = np.random.default_rng(1).standard_normal(
        (2, 8, 8, 3)).astype(np.float32)
    want = JaxSession.from_resnet(cfg, params, state).auto_configure(
        3e-3, calib=jnp.asarray(images), method="greedy")
    got = Session.from_resnet(mine_cfg, tp, ts, device="cpu").auto_configure(
        3e-3, calib=images, method="greedy")
    assert got.method == "greedy" and got.n_evals == want.n_evals
    assert got.assignments == want.assignments
    assert got.error == pytest.approx(want.error, rel=1e-2)


def test_auto_configured_session_reports_and_saves(resnet_pair, tmp_path):
    js, ts, images = resnet_pair
    mine = ts.replace(policy=None)
    mine.auto_configure(1e-3, calib=images)
    ref = js.replace(policy=JaxPolicy.from_json(
        NumericsPolicy.to_json(mine.numerics)))
    assert mine.is_policy
    assert mine.ppa_report() == ref.ppa_report()
    path = tmp_path / "policy.json"
    mine.save_policy(str(path))
    assert JaxPolicy.from_json(path.read_text()).lookup("stem").mode == \
        mine.numerics.lookup("stem").mode
    paths = mine.layer_paths()
    assert hlo_analysis.policy_compute_scale(mine.numerics, paths) == \
        jax_hlo.policy_compute_scale(ref.numerics, paths)


def test_auto_configure_lm_branch():
    """The LM branch: one calibration pass over seeded tokens, every
    projection and the head recorded, the emitted policy within budget
    when measured."""
    sess = Session("qwen3-4b", device="cpu")
    res = sess.auto_configure(1e-2)
    assert res.n_evals == 1 and res.assignments
    assert res.error <= 1e-2 and sess.is_policy
    assert {p for p, _ in res.assignments} <= set(sess.layer_paths())
    from repro_torch.core.metrics import mred
    from repro_torch.models import transformer

    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, sess.config.vocab, (2, 16)))
    base = Session("qwen3-4b", device="cpu")
    with torch.no_grad():
        h, _ = transformer.backbone(base.params, base.config,
                                    {"tokens": tokens})
        ref = transformer.logits_fn(base.params, base.config, h)
        h, _ = transformer.backbone(base.params, sess.config,
                                    {"tokens": tokens})
        got = transformer.logits_fn(base.params, sess.config, h)
    assert mred(got, ref) <= 1e-2


def test_auto_configure_lm_branch_matches_jax():
    """The LM branch against the JAX package's on the same carried weights:
    both draw the calibration tokens from ``default_rng(seed)``."""
    js = JaxSession.from_pretrained("qwen3-4b", QWEN_FIXTURE)
    params = params_from_numpy(jax.tree.map(np.asarray, js.params),
                               get_arch("qwen3-4b").reduced(), "cpu")
    want = js.auto_configure(1e-2)
    got = Session("qwen3-4b", params=params, device="cpu").auto_configure(
        1e-2)
    assert got.method == want.method == "proxy"
    assert got.assignments == want.assignments
    assert got.error == pytest.approx(want.error, rel=5e-2)
    assert (got.area_um2, got.baseline_area_um2) == \
        (want.area_um2, want.baseline_area_um2)


def test_auto_configure_checks_its_inputs(resnet_pair):
    _, ts, _ = resnet_pair
    from repro_torch.session import SessionError

    with pytest.raises(SessionError, match="calibration image batch"):
        ts.auto_configure(1e-2)
    with pytest.raises(ValueError, match="unknown method"):
        sweep.auto_configure(lambda p: 0.0, ["a"], 1e-3, method="magic")


def test_table2_driver_on_the_cpu(capsys):
    from repro_torch.bench import table2_ppa

    rows, points = table2_ppa.run(device="cpu", n_samples=1000)
    assert set(rows) == set(jax_ppa.TABLE2_SPECS)
    est = jax_ppa.estimate("ac", name="AC4-4", n=4)
    assert rows["AC4-4"][0] == est.logic_area_um2
    assert [p.name for p in points] == \
        [p.name for p in jax_sweep.sweep(n_samples=1000)]
    out = capsys.readouterr().out
    assert "Table II" in out and "paper headline" in out


def test_table4_driver_on_the_cpu(capsys, tmp_path):
    from repro_torch.bench import table4_resnet

    cfg = resnet.ResNetConfig(widths=(4, 8), blocks=(1, 1))
    rows = table4_resnet.run(device="cpu", eval_n=2, cfg=cfg,
                             designs=["AC5-5", "NC"], train_steps=2)
    assert set(rows) == {"Exact", "AC5-5", "NC"}
    assert 0.0 <= rows["AC5-5"]["agree"] <= 1.0
    assert 0.0 <= rows["AC5-5"]["top1"] <= 1.0
    assert rows["AC5-5"]["mred"] == pytest.approx(3.36e-4, rel=0.05)
    assert "[resnet-train] step    1" in capsys.readouterr().out
    out = tmp_path / "policy.json"
    res = table4_resnet.run_auto(1e-2, device="cpu", calib_n=2, cfg=cfg,
                                 out=str(out), train_steps=2)
    assert res.n_evals == 1 and out.exists()
    # a checkpoint instead of seeded weights
    rows = table4_resnet.run(
        device="cpu", eval_n=1, designs=["AC6-6"],
        weights=os.path.join(os.path.dirname(__file__), "golden", "compat",
                             "resnet18"))
    assert set(rows) == {"Exact", "AC6-6"}
