"""The port's device settings and TRAIN.TENSOR_PARALLEL check.

- ``device.no_tf32_no_bf16_reduction`` turns off TF32 in cuBLAS and cuDNN
  and cuBLAS's reduced-precision bf16 reduction (on the CPU too: they are
  process-wide flags), and ``resolve_device`` calls it for a CUDA device
  only (the ``gpu`` case is in test_torch_port_gpu.py).
- ``parallel.tp.resolve_tp`` against ``rpo_tpu.parallel.tp.resolve_tp``
  under the same device counts (monkeypatched): the same results, the
  same warning once for each requested value on one device, the same
  error for a count the devices do not divide by; and the port's
  DataManager, built twice with TRAIN.TENSOR_PARALLEL 2 on one device,
  warns once, as the JAX package's does.
"""
import os

import jax
import pytest
import torch

import rpo_tpu.parallel.tp as jtp
from rpo_tpu_torch import device
from rpo_tpu_torch.parallel import tp as ttp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ((torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"),
         (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction"))


@pytest.fixture
def saved_flags():
    saved = [getattr(obj, name) for obj, name in FLAGS]
    yield
    for (obj, name), value in zip(FLAGS, saved):
        setattr(obj, name, value)


def test_flag_function_turns_all_three_off(saved_flags):
    for obj, name in FLAGS:
        setattr(obj, name, True)
    device.no_tf32_no_bf16_reduction()
    assert [getattr(obj, name) for obj, name in FLAGS] == [False, False, False]


def test_resolve_device_leaves_the_flags_alone_on_the_cpu(saved_flags):
    for obj, name in FLAGS:
        setattr(obj, name, True)
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert [getattr(obj, name) for obj, name in FLAGS] == [True, True, True]


def _cfg(tp):
    return type("Cfg", (), {"TRAIN": type("TRAIN", (), {"TENSOR_PARALLEL": tp})})


@pytest.fixture
def counts(monkeypatch):
    """Sets the device count both packages see; fresh warn-once sets."""
    monkeypatch.setattr(jtp, "_WARNED_SINGLE_DEVICE", set())
    monkeypatch.setattr(ttp, "_WARNED_SINGLE_DEVICE", set())

    def set_count(n):
        monkeypatch.setattr(jax, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)

    return set_count


@pytest.mark.parametrize("n,requests", [
    (1, [0, 1, 2, 2, 4, 2, 4]),
    (4, [0, 1, 2, 4]),
    (8, [2, 4, 8]),
])
def test_resolve_tp_equals_jax(counts, capsys, n, requests):
    counts(n)
    got = [ttp.resolve_tp(_cfg(tp)) for tp in requests]
    port_out = capsys.readouterr().out
    want = [jtp.resolve_tp(_cfg(tp)) for tp in requests]
    assert got == want and port_out == capsys.readouterr().out
    if n == 1:  # one warning for each distinct value asked for, none for 0 and 1
        assert got == [0] * len(requests)
        assert port_out.count("(!) TRAIN.TENSOR_PARALLEL=") == 2
        assert "(!) TRAIN.TENSOR_PARALLEL=2 requested but only 1 device is visible" in port_out


@pytest.mark.parametrize("n,tp", [(4, 3), (2, 4), (6, 4)])
def test_resolve_tp_raises_as_jax(counts, n, tp):
    counts(n)
    with pytest.raises(ValueError) as port_err:
        ttp.resolve_tp(_cfg(tp))
    with pytest.raises(ValueError) as jax_err:
        jtp.resolve_tp(_cfg(tp))
    assert str(port_err.value) == str(jax_err.value) == (
        f"TRAIN.TENSOR_PARALLEL={tp} does not divide the {n} visible devices")


def test_cpu_host_counts_one_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert ttp.device_count() == 1


def test_data_manager_warns_once(counts, capsys):
    from rpo_tpu_torch.data.manager import DataManager
    from rpo_tpu_torch.engine.config import get_cfg_default

    counts(1)
    cfg = get_cfg_default()
    cfg.merge_from_file(os.path.join(REPO, "configs/datasets/synthetic.yaml"))
    cfg.merge_from_list(["TRAIN.TENSOR_PARALLEL", "2", "DATALOADER.NUM_WORKERS", "1"])
    DataManager(cfg)
    DataManager(cfg)
    out = capsys.readouterr().out
    assert out.count("(!) TRAIN.TENSOR_PARALLEL=2 requested but only 1 device is visible") == 1


def test_data_manager_says_a_mesh_is_not_ported(counts, capsys):
    from rpo_tpu_torch.data.manager import DataManager
    from rpo_tpu_torch.engine.config import get_cfg_default

    counts(4)
    cfg = get_cfg_default()
    cfg.merge_from_file(os.path.join(REPO, "configs/datasets/synthetic.yaml"))
    cfg.merge_from_list(["TRAIN.TENSOR_PARALLEL", "2", "DATALOADER.NUM_WORKERS", "1"])
    DataManager(cfg)
    assert "(!) TRAIN.TENSOR_PARALLEL=2: one process drives one device; launch one rank a " \
        "card with torchrun for the tensor-parallel mesh" in capsys.readouterr().out
