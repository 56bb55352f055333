"""The four examples of the PyTorch port (``examples/torch_*.py``) run on
the CPU at their smallest sizes: each ends its output with ``on cpu``,
shows what the reference example shows (the cached engine's speedup,
the placement flips and the failover, the prefix hits of three cache
families, a trained and checkpointed EMSNet), and without ``--device
cpu`` asks for the card. The training example takes a few steps only."""
import json
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _main(name):
    return runpy.run_path(str(EXAMPLES / f"torch_{name}.py"),
                          run_name="example")["main"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_quickstart_on_cpu(capsys):
    _main("quickstart")(["--device", "cpu"])
    out = _lines(capsys)
    assert out[0].startswith("profile:")
    assert out[1].startswith("direct:") and out[2].startswith("cached:")
    assert "EMSServe speedup over direct multimodal inference" in out[-1]
    assert out[-1].endswith("on cpu")


def test_serve_episode_on_cpu(capsys):
    _main("serve_episode")(["--device", "cpu"])
    out = _lines(capsys)
    events = [ln for ln in out if ln.startswith("[")]
    assert len(events) == 21
    assert any("edge crash" in ln for ln in out)
    # after the crash at event 12 every event is served on the glass
    assert all("-> glass" in ln for ln in events[12:])
    assert out[-1].startswith("cumulative:") and out[-1].endswith("on cpu")


def test_llm_generate_on_cpu(capsys):
    _main("llm_generate")(["--device", "cpu"])
    out = _lines(capsys)
    assert [ln.split()[0] for ln in out] == [
        "mistral-nemo-12b", "rwkv6-1.6b", "deepseek-v3-671b"]
    assert all("4/4 prefix hits, encoded 8 vs 136" in ln for ln in out)
    assert out[-1].endswith("on cpu")


def test_train_emsnet_e2e_on_cpu(capsys, tmp_path):
    out_path = tmp_path / "ems"
    _main("train_emsnet_e2e")([
        "--device", "cpu", "--text-encoder", "microbert", "--steps", "4",
        "--d1-size", "120", "--d2-size", "60", "--batch", "16",
        "--out", str(out_path)])
    out = _lines(capsys)
    assert out[0] == "EMSNet microbert-gru-fc on cpu"
    assert any(ln.startswith("3-modal PMI test:") for ln in out)
    assert out[-1].endswith("on cpu") and str(out_path) in out[-1]
    with np.load(out_path.with_suffix(".npz")) as npz:
        assert {k.split("/")[0] for k in npz.files} == {"m2", "m3"}
    meta = json.loads(out_path.with_suffix(".json").read_text())["metadata"]
    assert "metrics3" in meta


@pytest.mark.parametrize("name", ["quickstart", "serve_episode",
                                  "llm_generate"])
def test_examples_ask_for_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(name)([])
