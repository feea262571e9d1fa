"""The port's kernel selftest (``rpo_tpu_torch/ops/selftest.py``) on the CPU.

The runner's isolation against the JAX package's ``run_selftest`` (the
same status strings and counts for a pass, a mismatch and a raising
check), the port's own rule for CUDA errors, the table against the list
of checks ``chip_smoke.py`` phase 3 ran before it moved into the package,
and the table's small-shape checks with the plain versions in the kernels'
slots (they pass) and with planted faults (they fail).  On the card the
``gpu`` tests of ``test_torch_port_gpu.py`` run the whole table.
"""
import json
import math
import os
import subprocess
import sys
from collections import Counter

import pytest
import torch

from rpo_tpu_torch.ops import fused_rect_layer as frl
from rpo_tpu_torch.ops import fused_text_layer as ftl
from rpo_tpu_torch.ops import masked_attention as ma
from rpo_tpu_torch.ops import preprocess
from rpo_tpu_torch.ops import rect_attention as ra
from rpo_tpu_torch.ops import selftest as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fakes(calls):
    """A pass, a mismatch and a check that raises, each counting its calls."""
    def counted(name, value):
        def run():
            calls[name] += 1
            if isinstance(value, Exception):
                raise value
            return value
        return run

    return [("passes", counted("passes", 1e-3)), ("mismatch", counted("mismatch", 0.5)),
            ("raises", counted("raises", ValueError("boom")))]


def test_runner_gives_the_jax_statuses_and_counts(monkeypatch):
    from rpo_tpu.ops import selftest as jst

    jax_calls, port_calls = Counter(), Counter()
    monkeypatch.setattr(jst, "_checks", lambda *a, **k: iter(_fakes(jax_calls)))
    monkeypatch.setattr(jst.time, "sleep", lambda s: None)
    want = jst.run_selftest(tol=2e-2, retries=1, verbose=False)
    table = [st.Check(name, "rect_attention", (1,), 2e-2, run)
             for name, run in _fakes(port_calls)]
    got = st.run_checks(table, retries=1, verbose=False)
    assert got["checks"] == want["checks"]
    assert got["checks"]["passes"] == "ok (err=1.00e-03)"
    assert got["checks"]["mismatch"].startswith("FAILED: mismatch err=5.000e-01 >= tol=0.02")
    assert got["checks"]["raises"] == "FAILED: ValueError: boom"
    for key in ("metric", "value", "unit", "total"):
        assert got[key] == want[key], key
    assert (got["value"], got["total"]) == (1, 3)
    # a raising check is retried, a mismatch never
    assert port_calls == jax_calls == Counter(passes=1, mismatch=1, raises=2)


def test_a_cuda_error_ends_the_run():
    calls = Counter()

    def check(name, value):
        def run():
            calls[name] += 1
            if isinstance(value, Exception):
                raise value
            return value
        return st.Check(name, "rect_attention", (1,), 2e-2, run)

    table = [check("first", 0.0),
             check("flaky", OSError("transient")),
             check("faults", RuntimeError("CUDA error: an illegal memory access was encountered")),
             check("after", 0.0), check("last", 0.0)]
    out = st.run_checks(table, retries=2, verbose=False)
    assert out["checks"]["first"] == "ok (err=0.00e+00)"
    assert out["checks"]["flaky"] == "FAILED: OSError: transient"
    assert out["checks"]["faults"].startswith("FAILED: RuntimeError: CUDA error")
    assert out["checks"]["after"] == out["checks"]["last"] == "not run: CUDA context lost at faults"
    assert (out["value"], out["total"]) == (1, 5)
    assert calls == Counter(first=1, flaky=3, faults=1)  # no retry of a CUDA error
    assert st.is_cuda_error(RuntimeError("rect_attention kernel launch failed (719): x"))
    assert not st.is_cuda_error(ValueError("CUDA error"))


def test_a_reading_carries_its_other_conditions():
    table = [st.Check("equal", "rect_attention", (1,), 1.0,
                      lambda: st.Reading(0.5, True, "mean 1e-05", 0.25)),
             st.Check("not equal", "rect_attention", (1,), 1.0,
                      lambda: st.Reading(0.5, False, "same: False", 0.25))]
    out = st.run_checks(table, verbose=False)
    assert out["checks"] == {"equal": "ok (err=5.00e-01); mean 1e-05",
                             "not equal": "FAILED: mismatch err=5.000e-01; same: False"}
    assert out["max_abs_err"] == {"equal": 0.25, "not equal": 0.25}


# chip_smoke.py phase 3 at e64c4af, check by check: (kind, kernel, shape)
PHASE3 = (
    [("compare", "rect_attention", s) for s in (
        (100, 12, 221, 197, 64), (100, 6, 221, 197, 128), (100, 12, 197, 197, 64),
        (3, 2, 9, 5, 32), (3, 1, 9, 5, 64), (2, 12, 221, 197, 64), (2, 4, 221, 197, 128),
        (2, 3, 70, 130, 32), (2, 2, 33, 300, 64), (2, 3, 1, 1, 64), (2, 3, 17, 16, 64),
        (2, 3, 17, 17, 64), (2, 2, 17, 256, 64), (2, 2, 17, 257, 64), (2, 2, 1, 300, 64),
        (2, 4, 17, 257, 32), (2, 4, 17, 16, 128), (2, 4, 33, 129, 128),
        (4, 12, 197, 197, 64), (4, 12, 24, 197, 64),  # the RPO train step
        (32, 12, 197, 197, 64), (1, 12, 197, 197, 64))]  # the baselines' image tower
    + [("contract", "rect_attention", (100, 12, 197, 197, 64)),
       ("refusal", "rect_attention", (1, 1, 8, 197, 128))]
    + [("compare", "masked_attention", s) for s in (
        (51, 8, 77, 77, 64), (51, 8, 24, 24, 64), (51, 8, 16, 16, 64), (51, 8, 77, 77, 64),
        (4, 12, 221, 221, 64), (3, 2, 10, 10, 32), (2, 4, 77, 77, 128), (2, 3, 70, 70, 32),
        (3, 5, 16, 16, 64), (3, 5, 16, 16, 64), (3, 5, 16, 16, 64), (3, 3, 24, 24, 64),
        (3, 3, 24, 24, 64), (7, 3, 77, 77, 64), (3, 5, 16, 16, 128),
        (10, 8, 16, 16, 64), (80, 8, 16, 16, 64))]  # the last two under grad
    + [("refusal", "masked_attention", (2, 2, 77, 77, 64))]
    + [("contract", "masked_attention", (51, 8, L, L, 64)) for L in (77, 24, 16)]
    + [("compare", "fused_text_layer", s) for s in (
        (510, 16, 512, 8), (408, 16, 512, 8), (13, 16, 64, 2), (4, 80, 512, 8),
        (3, 80, 768, 12))]
    + [("control", "fused_text_layer", (510, 16, 512, 8)),
       ("refusal", "fused_text_layer", (13, 16, 64, 2))]
    + [("compare", what, s) for s in (
        (100, 221, 768, 12, 197), (100, 197, 768, 12, 197), (3, 37, 256, 4, 29),
        (3, 43, 768, 12, 40), (2, 64, 64, 1, 50), (3, 13, 128, 2, 9), (2, 257, 128, 2, 256))
       for what in ("fused_rect_attn_half", "fused_mlp_half")]
    + [("control", what, (100, 221, 768, 12, 197))
       for what in ("fused_rect_attn_half", "fused_mlp_half")]
    + [("refusal", what, (2, 257, 128, 2, 256))
       for what in ("fused_rect_attn_half", "fused_mlp_half")]
)
# the JAX selftest's checks that phase 3 lacked
JAX_ONLY = [("compare", "rect_attention", (4, 6, 221, 197, 128)),  # paired backward
            ("compare", "rect_attention", (4, 221, 768, 12, 197)),  # rect residual block
            ("compare", "device_eval_preprocess", (4, 64, 64, 224)),
            ("compare", "device_train_preprocess", (4, 64, 64, 224))]


def test_the_table_is_phase_3s_checks_and_the_jax_selftests():
    table = st.checks(device="cpu")  # builds nothing, runs nothing
    assert Counter((c.kind, c.kernel, c.shape) for c in table) == Counter(PHASE3 + JAX_ONLY)
    assert len({c.name for c in table}) == len(table) == 74
    assert all(c.name.startswith(f"kernel {c.kernel} ") for c in table)
    for c in table:  # the bounds phase 3 held each to
        bf16 = "float32" not in c.name
        want = {"compare": st.BF16_TOL if bf16 else st.F32_TOL, "contract": 1.1,
                "refusal": 0.0, "control": math.inf}[c.kind]
        if c.kernel.startswith("fused") and c.kind == "compare":
            want = 1.0  # the error over tol x max(|plain|, 1), element by element
        if c.kernel.startswith("device_"):
            want = 2.01 / (min(st.CLIP_STD) * 255)
        assert c.bound == pytest.approx(want), c.name
    assert {c.kernel for c in table} == set(st.SLOTS)
    assert st.checks(tol=1e-3, device="cpu")[0].bound == 1e-3
    with pytest.raises(KeyError, match="no kernel slot"):
        st.checks(device="cpu", kernels={"sdpa": None})


def _rect(q, k, v):
    ra._check(q, k, v)  # the wrapper's refusals, then its plain version
    return ra.rect_attention_reference(q, k, v)


def _masked(q, k, v, bias):
    ma._check(q, k, v, bias.float())
    return ma.masked_attention_reference(q, k, v, bias)


def _text(x, blk, heads, mask):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused text layer kernel takes bfloat16, got {x.dtype}")
    return ftl.fused_text_layer_reference(x, blk, heads, mask)


def _attn_half(x, ln_1, attn, heads, n_kv, kernel=None):
    frl._check_x(x, "attention half")
    return frl.fused_rect_attn_half(x, ln_1, attn, heads, n_kv)  # the plain version on the CPU


PLAIN = {"rect_attention": _rect, "masked_attention": _masked, "fused_text_layer": _text,
         "fused_rect_attn_half": _attn_half, "fused_mlp_half": frl.fused_mlp_half,
         "device_eval_preprocess": preprocess.device_eval_preprocess,
         "device_train_preprocess": preprocess.device_train_preprocess}


def _small(check) -> bool:
    return check.shape[0] < 32


@pytest.mark.parametrize("kernel", st.SLOTS)
def test_small_checks_pass_with_the_plain_versions_in_the_kernels_slots(kernel):
    def mine(check):
        return check.kernel == kernel and _small(check)

    out = st.run_selftest(device="cpu", kernels=PLAIN, only=mine, verbose=False)
    small = [c for c in st.checks(device="cpu") if mine(c)]
    assert small and {c.kind for c in small} <= {"compare", "refusal"}
    failed = {n: s for n, s in out["checks"].items() if not s.startswith("ok")}
    assert not failed and out["value"] == out["total"] == len(small)
    assert out["metric"] == "kernel_selftest" and out["backend"] == "cpu"
    assert set(out) >= {"metric", "value", "unit", "total", "checks", "backend", "device",
                        "seconds", "nvidia_smi", "max_abs_err"}
    json.dumps(out)
    err = st.first_max_abs_err(out, kernel)
    # a plain version in its own slot is exact; the device preprocess is
    # held to the host's resample, within two uint8 steps
    assert err == 0.0 or (kernel.startswith("device_") and err <= st.U8_TOL)


def test_production_controls_catch_the_dropped_bias_with_the_plain_versions():
    out = st.run_selftest(device="cpu", kernels=PLAIN, only=lambda c: c.kind == "control",
                          verbose=False)
    assert out["total"] == 3 and out["value"] == 3, out["checks"]
    assert all("caught" in s for s in out["checks"].values())


def _lost_key_tiles(q, k, v):
    """The rect attention without its partial last 16-key tile."""
    n = (k.shape[-2] // 16) * 16
    return ra.rect_attention_reference(q, k[..., :n, :], v[..., :n, :])


def _no_out_b_text(x, blk, heads, mask):
    attn = {**blk["attn"], "out_b": torch.zeros_like(blk["attn"]["out_b"])}
    return _text(x, {**blk, "attn": attn}, heads, mask)


def _no_out_b_half(x, ln_1, attn, heads, n_kv, kernel=None):
    return _attn_half(x, ln_1, {**attn, "out_b": torch.zeros_like(attn["out_b"])}, heads, n_kv)


def _no_flips(images, boxes, flips, size, mean, std):
    return preprocess.device_train_preprocess(images, boxes, torch.zeros_like(flips), size,
                                              mean, std)


@pytest.mark.parametrize("fault,kernel,fn", [
    ("lost key tiles", "rect_attention", _lost_key_tiles),
    ("a dropped out_b", "fused_text_layer", _no_out_b_text),
    ("a dropped out_b", "fused_rect_attn_half", _no_out_b_half),
    ("dropped flips", "device_train_preprocess", _no_flips),
])
def test_planted_faults_fail_their_checks(fault, kernel, fn):
    def hit(c):
        if c.kernel != kernel or c.kind == "refusal" or not _small(c):
            return False
        return kernel != "rect_attention" or c.shape[-2 if len(c.shape) == 5 else -1] % 16 != 0

    out = st.run_selftest(device="cpu", kernels={**PLAIN, kernel: fn}, only=hit, verbose=False)
    assert out["total"] >= 1
    assert out["value"] == 0, {n: s for n, s in out["checks"].items() if s.startswith("ok")}


def test_the_selftest_refuses_the_cpu_without_slots():
    with pytest.raises(RuntimeError, match="kernels="):
        st.run_selftest(device="cpu", verbose=False)


def test_the_cli_without_a_card_exits_nonzero_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", RPO_TPU_FORCE_CPU="1")
    proc = subprocess.run([sys.executable, "-m", "rpo_tpu_torch.tools.kernel_selftest"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"value"' not in proc.stdout and "ok (" not in proc.stdout
