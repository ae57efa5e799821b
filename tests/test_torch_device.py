"""The port's entry points default to the card: without CUDA they raise
unless the caller asks for ``device="cpu"``."""

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.device import resolve_device
from repro_torch.launch import serve as tserve
from repro_torch.launch.specs import build_model
from repro_torch.models.decoder import HybridDecoderLM
from repro_torch.nn.module import init_params
import test_torch_threads  # noqa: F401  (one thread budget per worker)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["resolve_device", "build_model", "model",
                                   "init_params", "convert", "serve"])
def test_entry_points_raise_without_cuda(no_cuda, entry):
    cfg = tq.SMOKE
    calls = {
        "resolve_device": lambda: resolve_device(),
        "build_model": lambda: build_model(cfg),
        "model": lambda: HybridDecoderLM(cfg),
        "init_params": lambda: init_params(
            build_model(cfg, device="cpu").specs(), 0),
        "convert": lambda: convert.from_reference(
            cfg, {"embed": {"table": np.zeros((2, 2), np.float32)}}),
        "serve": lambda: tserve.main(["--model", "qwen3-0.6b", "--smoke"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_cpu_is_served_when_asked(no_cuda):
    outs = tserve.main(["--model", "qwen3-0.6b", "--smoke", "--device",
                        "cpu", "--batch", "2", "--cache-len", "16",
                        "--n-requests", "3", "--max-new", "2",
                        "--quantize", "int8"])
    assert [len(o) for o in outs] == [2, 2, 2]
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="unsupported device"):
        resolve_device("meta")
