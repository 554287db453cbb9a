"""serve/app.py::get_model gives one ModelHandle for every spelling of a
device, so a reload or configure_batching through one reaches every
surface (the spellings on the card: tests/test_torch_cuda.py)."""

import pytest
import torch

from tests.torch_port import write_serving_config
from vqvaehmm_tpu_torch.core.device import canonical_device
from vqvaehmm_tpu_torch.serve.app import get_model


@pytest.fixture
def cfg_path(tmp_path):
    get_model.cache_clear()
    yield write_serving_config(tmp_path)
    get_model.cache_clear()


def test_cpu_spellings_share_one_handle(cfg_path):
    h = get_model(cfg_path, "cpu")
    for spelling in (dict(device="cpu"), dict(device=torch.device("cpu")),
                     dict(device="cpu:0"),
                     dict(device=torch.device("cpu", 0))):
        assert get_model(cfg_path, **spelling) is h, spelling
    get_model.cache_clear()
    assert get_model(cfg_path, "cpu") is not h


def test_canonical_device():
    assert canonical_device("cpu:0") == torch.device("cpu")
    assert str(canonical_device(torch.device("cpu"))) == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            canonical_device("cuda")
