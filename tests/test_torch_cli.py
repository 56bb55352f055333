"""The port's serve launcher against the reference's, on the CPU: the
deprecated ``--batched/--stream/--tiered N`` shims and the ``--fleet``
mode (``repro_torch.launch.serve``; ``tests/test_cli.py`` holds the
reference's own validation cases).

Messages are read from the reference launcher itself, so each case
pins the port's text to the reference's, not to a copy of it.
"""
import argparse
import contextlib
import io
import re

import pytest
import torch

from repro.launch import serve as JL
from repro_torch.launch import serve as PL
from repro_torch.obs import audit_file

CPU = ["--device", "cpu", "--text-encoder", "microbert"]
LEGACY = [("--batched", "batch"), ("--stream", "stream"),
          ("--tiered", "tiered")]


def _port(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        PL.main([*CPU, *argv])
    return buf.getvalue().splitlines()


def _ref_exit(monkeypatch, *argv):
    """The reference launcher's refusal message for ``argv``."""
    monkeypatch.setattr("sys.argv", ["serve.py", *argv])
    with pytest.raises(SystemExit) as e:
        JL.main()
    return str(e.value)


def _ref_note(flag, n):
    ns = argparse.Namespace(batched=0, stream=0, tiered=0, engine="",
                            sessions=4)
    setattr(ns, flag.lstrip("-"), n)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JL._apply_legacy_shims(ns)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("flag,spec", LEGACY)
def test_legacy_flag_is_the_engine_spec(monkeypatch, flag, spec):
    """The shim prints the reference's deprecation note and serves the
    call ``--engine SPEC --sessions N`` makes, argument for argument."""
    calls = []

    def record(args, spec_tokens, dev):
        calls.append((spec_tokens, str(dev), {
            k: v for k, v in vars(args).items()
            if k not in ("batched", "stream", "tiered")}))
    monkeypatch.setattr(PL, "serve_unified", record)
    out = _port(flag, "3")
    assert out == _ref_note(flag, 3)
    assert _port("--engine", spec, "--sessions", "3") == []
    assert calls[0] == calls[1] and calls[0][0] == (spec,)


@pytest.mark.parametrize("flag,spec", LEGACY)
def test_legacy_flag_conflicts_with_engine(monkeypatch, flag, spec):
    want = _ref_exit(monkeypatch, flag, "3", "--engine", spec)
    with pytest.raises(SystemExit) as e:
        _port(flag, "3", "--engine", spec)
    assert str(e.value) == want == (f"{flag} conflicts with --engine; "
                                    "use --engine alone")


@pytest.mark.parametrize("flag,spec", LEGACY[:2])
def test_legacy_flag_serves_like_the_engine_spec(flag, spec):
    """Served for real: the same lines as the ``--engine`` form, numbers
    measured on the wall clock masked."""
    def masked(lines):
        return [re.sub(r" *\d+\.\d+", "#", ln) for ln in lines]
    legacy = _port(flag, "4")
    assert legacy[0].startswith(f"note: {flag} N is deprecated")
    assert masked(legacy[1:]) == masked(
        _port("--engine", spec, "--sessions", "4"))
    assert legacy[-1].endswith("on cpu")


@pytest.mark.parametrize("argv", [
    ["--fleet", "4", "--engine", "batch"],
    ["--fleet", "4", "--replicas", "0"],
    ["--fleet", "-1"],
], ids=["engine", "replicas0", "negative_rate"])
def test_fleet_refusals_match_reference(monkeypatch, argv):
    want = _ref_exit(monkeypatch, *argv)
    with pytest.raises(SystemExit) as e:
        _port(*argv)
    assert str(e.value) == want


def test_fleet_serves_on_cpu_with_trace_and_metrics(tmp_path):
    trace, prom = tmp_path / "t.jsonl", tmp_path / "m.prom"
    out = _port("--fleet", "4", "--replicas", "2", "--sessions", "6",
                "--trace", str(trace), "--metrics-out", str(prom))
    assert out[0].startswith("fleet: 2 replicas, params on 1x1 mesh over "
                             "1 device(s) (")
    summary = next(ln for ln in out if ln.startswith("admitted TTFP"))
    assert summary.endswith("finalized sessions/s on cpu")
    # the flushes cost their wall on this host's clock, so how many
    # sessions the 500 ms deadline sheds depends on the machine's load:
    # every session is admitted or shed, every admitted one finalizes
    offered = next(ln for ln in out if "sessions offered @ 4/s" in ln)
    n, admitted, finalized, shed = (int(x) for x in re.match(
        r"(\d+) sessions offered @ 4/s: (\d+) admitted \((\d+) finalized"
        r"\), (\d+) shed to glass", offered).groups())
    assert n > 0 and admitted + shed == n and finalized == admitted
    assert sum(ln.startswith("  replica ") for ln in out) == 2
    assert out[-1].startswith("trace: ") and str(trace) in out[-1]
    text = prom.read_text()
    assert f"emsserve_fleet_sessions_offered {n}" in text
    # TTFP is observed once an admitted session (fleet.ttfp_s) and once a
    # shed session's first glass partial (fleet.ttfp_degraded_s), so the
    # split follows the load-dependent shedding above
    assert f"emsserve_fleet_ttfp_s_count {admitted}" in text
    if shed:
        assert f"emsserve_fleet_ttfp_degraded_s_count {shed}" in text
    report = audit_file(trace)
    assert report.ok, report.violations


def test_fleet_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the launcher would serve on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.main(["--text-encoder", "microbert", "--fleet", "4"])
