"""The port's session CLI (``python -m repro_torch.session``) against the
JAX package's (``python -m repro.session``): the same subcommands, flags,
defaults, output lines and exit codes, run in-process with ``--device
cpu``.

Lines are compared word for word with their numbers read apart: seconds
and tok/s are the hosts' and are skipped; every other number must agree
to NUMBER_RTOL.  The PPA line's last figure is named "modeled compute
passes" in the port and "modeled compute latency" in the JAX package (a
pass scale, not a device latency; ROADMAP.md section 3).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro import session as jax_session
from repro_torch import session as port_session
from repro_torch.core.policy import NumericsPolicy
from repro_torch.session import SessionError, parse_tiers

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "compat")
QWEN = os.path.join(GOLDEN, "qwen3-4b")
# numbers printed by both CLIs from the same weights: fitted calibration
# statistics (the proxy's tail factor) come out of fp32 sums in other
# orders; measured: 6.82 against 6.81 at most
NUMBER_RTOL = 1e-2
_NUM = re.compile(r"[-+]?\d[\d,]*\.?\d*(?:e[-+]?\d+)?")
# a timed figure: seconds and tokens per second
_TIMED = re.compile(r"in [\d.]+s \([\d.]+ tok/s( aggregate)?\)")


def _run(mod, argv, capsys, port):
    rc = mod.main(argv + (["--device", "cpu"] if port else []))
    out, err = capsys.readouterr()
    return rc, [line for line in out.splitlines() if line.strip()], err


def _split(line):
    line = _TIMED.sub("in <timed>", line).replace("compute latency",
                                                  "compute passes")
    return _NUM.sub("#", line), [float(n.replace(",", ""))
                                 for n in _NUM.findall(line)]


def _same_lines(mine, theirs, numbers=True):
    assert len(mine) == len(theirs), (mine, theirs)
    for a, b in zip(mine, theirs):
        (ta, na), (tb, nb) = _split(a), _split(b)
        assert ta == tb, (a, b)
        if numbers:
            np.testing.assert_allclose(na, nb, rtol=NUMBER_RTOL, atol=1e-12,
                                       err_msg=f"{a}\n{b}")


ACCEPTED = ["premium:exact,bulk:segmented1",
            "a:segmented3",
            " premium : exact , standard:segmented3,",
            "x:policy.json,y:exact"]
REJECTED = ["", ",", "premium", "premium:", ":exact",
            "a:exact,a:segmented1"]


@pytest.mark.parametrize("spec", ACCEPTED)
def test_parse_tiers_accepts_what_the_reference_accepts(spec):
    mine = parse_tiers(spec)
    theirs = jax_session.parse_tiers(spec)
    assert [(t.name, t.policy, t.priority) for t in mine] \
        == [(t.name, t.policy, t.priority) for t in theirs]


@pytest.mark.parametrize("spec", REJECTED)
def test_parse_tiers_rejects_what_the_reference_rejects(spec):
    with pytest.raises(SessionError) as mine:
        parse_tiers(spec)
    with pytest.raises(jax_session.SessionError) as theirs:
        jax_session.parse_tiers(spec)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("argv", [
    ["serve-loop", "--tiers", "premium"],
    ["serve-loop", "--tiers", "a:exact,a:exact"],
    ["generate", "--arch", "no-such-arch"],
    ["ppa", "--policy", "missing-policy.json"],
    ["generate", "--weights", "no-such-dir", "--arch", "qwen3-4b"],
])
def test_errors_exit_2_with_one_line_as_the_reference(argv, capsys):
    rc, out, err = _run(port_session, argv, capsys, port=True)
    rc_j, out_j, err_j = _run(jax_session, argv, capsys, port=False)
    assert rc == rc_j == 2 and out == out_j == []
    assert err.count("\n") == 1 and err.startswith("error: ")
    if "--weights" not in argv and "--arch" not in argv:
        assert err == err_j


def test_no_card_is_one_line_exit_2(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_session.main(["ppa"]) == 2
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "device='cpu'" in err


def test_module_runs_as_a_script():
    """``python -m repro_torch.session`` is the CLI: a bad tier spec exits
    2 with one line on stderr."""
    env = dict(os.environ, PYTHONPATH="src")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "repro_torch.session",
                          "serve-loop", "--device", "cpu", "--tiers", ":x"],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert out.stderr.strip() == ("error: bad tier spec ':x': expected "
                                  "name:policy (e.g. premium:exact)")


QWEN_CMDS = {
    "generate": ["generate", "--weights", QWEN, "--batch", "2",
                 "--prompt-len", "8", "--gen-len", "6"],
    "generate-policy": ["generate", "--weights", QWEN, "--policy",
                        "segmented2", "--batch", "2", "--prompt-len", "8",
                        "--gen-len", "4", "--eos-id", "7"],
    "serve-loop": ["serve-loop", "--weights", QWEN, "--tiers",
                   "premium:exact,standard:segmented3", "--requests", "4"],
    "ppa": ["ppa", "--weights", QWEN, "--policy", "segmented1"],
    "auto-configure": ["auto-configure", "--weights", QWEN, "--budget",
                       "1e-2"],
}


@pytest.mark.parametrize("name", list(QWEN_CMDS))
def test_qwen3_fixture_lines_equal_the_reference(name, capsys):
    argv = QWEN_CMDS[name]                  # --arch defaults to qwen3-4b
    rc, mine, _ = _run(port_session, argv, capsys, port=True)
    rc_j, theirs, _ = _run(jax_session, argv, capsys, port=False)
    assert rc == rc_j == 0
    _same_lines(mine, theirs)
    if name == "serve-loop":
        # the committed fixture's counts, as the reference prints them
        tiers = [line for line in mine if "finished" in line]
        assert len(tiers) == 2 and all(
            "2 finished, 32 tokens, 15 decode steps" in t for t in tiers)


ZAMBA_CMDS = {
    "generate": ["generate", "--arch", "zamba2-7b", "--batch", "2",
                 "--prompt-len", "12", "--gen-len", "5"],
    "serve-loop": ["serve-loop", "--arch", "zamba2-7b", "--tiers",
                   "premium:exact,standard:segmented3,bulk:segmented1",
                   "--requests", "5", "--slots", "2", "--max-len", "40"],
    "ppa": ["ppa", "--arch", "zamba2-7b", "--policy", "segmented3"],
}


@pytest.mark.parametrize("name", list(ZAMBA_CMDS))
def test_zamba2_lines_equal_the_reference(name, capsys):
    """Reduced zamba2-7b on seeded random weights (each package draws its
    own: only the lines' numbers that do not depend on the weights can
    agree, and all of them here do: counts, shapes, PPA figures)."""
    argv = ZAMBA_CMDS[name]
    rc, mine, _ = _run(port_session, argv, capsys, port=True)
    rc_j, theirs, _ = _run(jax_session, argv, capsys, port=False)
    assert rc == rc_j == 0
    _same_lines(mine, theirs)
    if name == "ppa":
        assert "policy over 51 call sites" in mine[0]


def test_zamba2_auto_configure_walks_the_reference_sites(tmp_path, capsys):
    """The proxy sweep over reduced zamba2-7b: one line a call site, in the
    reference's order (the 39 multiplier sites of the 51 paths: 12 SSD
    blocks' in/out projections, 7 a shared-block application, ``lm_head``;
    the scans take none), then the summary; the policy written to
    ``--out`` loads in both packages.  The calibration numbers come from
    each package's own random weights, so only the text is compared."""
    out = tmp_path / "policy.json"
    argv = ["auto-configure", "--arch", "zamba2-7b", "--budget", "1e-2"]
    rc, mine, _ = _run(port_session, argv + ["--out", str(out)], capsys,
                       port=True)
    rc_j, theirs, _ = _run(jax_session, argv, capsys, port=False)
    assert rc == rc_j == 0
    site = lambda lines: [line.split()[1] for line in lines
                          if line.startswith("[auto_configure/proxy]")
                          and "->" in line]
    assert site(mine) == site(theirs) and len(site(mine)) == 39
    assert mine[-1] == f"[session] policy written to {out}"
    _same_lines(mine[:-1], theirs, numbers=False)
    from repro.core.policy import NumericsPolicy as JaxPolicy

    text = out.read_text()
    assert NumericsPolicy.from_json(text).to_json() == text
    JaxPolicy.from_json(text)


def test_backend_names_map_as_policy_files_map_them():
    parse = port_session.build_parser().parse_args
    for name, want in [("xla", "torch"), ("interpret", "torch"),
                       ("pallas", "hopper"), ("hopper", "hopper"),
                       ("torch", "torch"), ("auto", "auto")]:
        sess = port_session._session(parse(["ppa", "--backend", name,
                                            "--device", "cpu"]))
        assert sess.backend == want
        assert sess.config.numerics.backend == want
    with pytest.raises(SystemExit):
        parse(["ppa", "--backend", "cuda"])
    args = parse(["generate"])
    assert (args.arch, args.batch, args.prompt_len, args.gen_len,
            args.device, args.full_size) == ("qwen3-4b", 4, 32, 16, "cuda",
                                             False)
    assert not any(a.dest in ("tune", "shape")
                   for a in port_session.build_parser()._actions)
