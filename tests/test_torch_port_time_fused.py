"""The fused-kernel timing tool's source variants and arguments, on the CPU:
an earlier source is built against the header that lies beside it, and
the tool refuses what it cannot run."""
import pytest

from rpo_tpu_torch.ops import _build
from rpo_tpu_torch.tools import time_fused as tf

HEADER = (_build.CSRC / tf.HEADER).read_text()


@pytest.mark.parametrize("name", ["fused_text_layer.cu", "fused_rect_layer.cu"])
def test_inline_header_replaces_only_the_include(name):
    source = (_build.CSRC / name).read_text()
    out = tf.inline_header(source, HEADER)
    assert tf.INCLUDE not in out and "#pragma once" not in out
    assert "namespace fused_layer {" in out and "__device__ inline void layer_norm_rows(" in out
    # the source around the include is kept as it was
    before, after = source.split(tf.INCLUDE + "\n")
    assert out.startswith(before) and out.endswith(after)
    body = out[len(before):len(out) - len(after)]
    assert body.rstrip("\n") == HEADER.replace("#pragma once\n", "").rstrip("\n")


@pytest.mark.parametrize("source", ["int x;\n", f"{tf.INCLUDE}\n{tf.INCLUDE}\n",
                                    '#include "other.cuh"\n'])
def test_inline_header_needs_exactly_one_include(source):
    with pytest.raises(ValueError):
        tf.inline_header(source, HEADER)


def test_variant_sources_take_the_header_beside_them(tmp_path):
    (tmp_path / tf.HEADER).write_text("#pragma once\nint old_header;\n")
    (tmp_path / "fused_text_layer.cu").write_text(f"// text\n{tf.INCLUDE}\nint text;\n")
    got = tf.variant_sources(tmp_path / "fused_text_layer.cu")
    assert got == {"fused_text_layer": "// text\nint old_header;\n\nint text;\n"}
    # a rect-layer source beside it joins the variant, with the same header
    (tmp_path / "fused_rect_layer.cu").write_text(f"{tf.INCLUDE}\nint rect;\n")
    got = tf.variant_sources(tmp_path / "fused_text_layer.cu")
    assert got["fused_rect_layer"] == "int old_header;\n\nint rect;\n"


@pytest.mark.parametrize("spec,want", [
    ("parent=build/parent/fused_text_layer.cu", ("parent", "build/parent/fused_text_layer.cu")),
    ("step1=a/b=c.cu", ("step1", "a/b=c.cu")),
])
def test_parse_source(spec, want):
    label, path = tf.parse_source(spec)
    assert (label, str(path)) == want


@pytest.mark.parametrize("spec", ["build/parent/fused_text_layer.cu", "=x.cu", "old=x.cuh",
                                  "this=x.cu", "phases=x.cu", "old="])
def test_parse_source_refuses(spec):
    with pytest.raises(ValueError):
        tf.parse_source(spec)


def test_main_checks_its_arguments_then_needs_a_card(monkeypatch):
    with pytest.raises(ValueError):
        tf.main(["--source", "this=x.cu"])
    monkeypatch.setattr(tf.torch.cuda, "is_available", lambda: False)
    assert tf.main(["--source", "old=missing/fused_text_layer.cu"]) == 1


def test_shapes_are_chip_smokes_fused_checks():
    """The tool's text-layer shapes are phase 3's fused checks, which the
    kernel selftest holds (``ops/selftest.py``)."""
    from rpo_tpu_torch.ops.selftest import FUSED_TEXT_CHECKS

    assert list(FUSED_TEXT_CHECKS) == [(label, shape) for label, shape in tf.TEXT_SHAPES]


@pytest.mark.parametrize("enum,names", [("Phase", tf.PHASES), ("Extra", tf.EXTRAS)])
def test_phase_names_follow_the_kernels_clocks(enum, names):
    """The tool reads the kernel's phase clocks in the order of its enums:
    one name per clock, so that an added phase cannot shift the report."""
    import re

    source = (_build.CSRC / "fused_text_layer.cu").read_text()
    body = re.search(r"enum %s \{([^}]*)\}" % enum, source).group(1)
    values = [v.strip() for v in body.split(",")]
    assert values[-1].startswith("k") and len(values) - 1 == len(names)
    # the clocks are written after the heads scratch's rows, kPhases then kExtras
    assert "tail[kPhases + k] = extra_clocks[k]" in source


def test_variant_sources_inline_every_header_once(tmp_path):
    """A source that includes two headers builds from one file: each
    include is replaced by the header beside it, in place."""
    (tmp_path / tf.HEADER).write_text("#pragma once\nint common;\n")
    (tmp_path / "attention_tc.cuh").write_text("#pragma once\nint attention;\n")
    (tmp_path / "fused_text_layer.cu").write_text(f"{tf.INCLUDE}\nint text;\n")
    (tmp_path / "fused_rect_layer.cu").write_text(
        f'// rect\n{tf.INCLUDE}\n#include "attention_tc.cuh"\n#include <math.h>\nint rect;\n')
    got = tf.variant_sources(tmp_path / "fused_text_layer.cu")
    assert got["fused_rect_layer"] == ("// rect\nint common;\n\nint attention;\n\n"
                                       "#include <math.h>\nint rect;\n")
    # the checkout's rect source includes both of its headers, each once
    checkout = tf.inline_headers(_build.CSRC / "fused_rect_layer.cu")
    assert '#include "' not in checkout
    assert "namespace attention_tc {" in checkout and "namespace fused_layer {" in checkout


def test_differences_counts_elements_and_the_largest():
    import torch

    a = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.bfloat16)
    b = a.clone()
    assert tf.differences(a, b) == (0, 0.0)
    b[1], b[3] = 2.015625, 3.96875
    assert tf.differences(a, b) == (2, 0.03125)


def test_mlp_shapes_are_chip_smokes_rect_checks():
    """The tool's MLP-half shapes are among phase 3's rect checks (the
    kernel selftest's, ``ops/selftest.py``), the two GEMM edges among
    them."""
    from rpo_tpu_torch.ops.selftest import RECT_HALF_CHECKS

    smoke = {shape[:3] for _, shape in RECT_HALF_CHECKS}
    shapes = [shape for _, shape in tf.MLP_SHAPES]
    assert set(shapes) <= smoke
    assert (3, 43, 768) in shapes and (2, 64, 64) in shapes  # 129 rows; d = 64
    assert tf.RECT_SHAPE[:3] == shapes[0]


def test_device_ms_is_the_sum_of_its_split_by_kernel(monkeypatch):
    """The timers read the profiler's device events by kernel name, over the
    calls; host events and empty kernels drop out; a window with no kernel
    is taken again, then reported as not measured (None)."""
    import types

    import torch

    from rpo_tpu_torch.tools import timing

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [types.SimpleNamespace(key=k, device_type=t, self_device_time_total=us)
              for k, t, us in (("fc", cuda, 3000.0), ("proj", cuda, 1000.0),
                               ("host op", cpu, 50.0), ("empty", cuda, 0.0))]
    windows = []

    class Window:
        def __enter__(self):
            windows.append(self)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", lambda activities: Window())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    assert timing.device_ms_by_kernel(lambda: calls.append(1), 2) == {"fc": 1.5, "proj": 0.5}
    assert len(calls) == 3 and len(windows) == 1  # one warm call, then the window's two
    assert timing.device_ms(lambda: None, 2) == 2.0
    events[:] = events[2:]
    windows.clear()
    assert timing.device_ms(lambda: None, 2) is None and len(windows) == 3


@pytest.mark.parametrize("has_layout", [True, False], ids=["core-matrices", "earlier-build"])
def test_text_builds_get_the_weight_layout_they_take(monkeypatch, has_layout):
    """A text-layer build with ``fused_text_layer_weight_layout`` is launched
    on the block's ``with_text_kernel_layout`` matrices; one without it (an
    earlier commit's) is handed them fragment-major, as it took them."""
    class Lib:
        pass

    lib = Lib()
    if has_layout:
        lib.fused_text_layer_weight_layout = lambda: 1
    monkeypatch.setattr(tf.ftl, "_lib", lambda: lib)
    monkeypatch.setattr(tf._build, "_loaded", {})
    monkeypatch.setattr(tf, "_fragment_major", False)  # restored after the test
    calls = []
    monkeypatch.setattr(tf.ftl, "_launch",
                        lambda x, blk, h, m, eps, mats=None: calls.append(("launch", mats)))
    monkeypatch.setattr(tf.ftl, "fused_text_layer",
                        lambda x, blk, h, m: calls.append(("layer", blk["kernel"])))
    tf.use({"fused_text_layer": lib})
    blk, frag = {"kernel": "core matrices"}, "fragment-major"
    tf.text_call(None, blk, frag, 2, None)
    assert calls == ([("layer", "core matrices")] if has_layout else [("launch", frag)])


def test_build_variants_builds_each_source_once(monkeypatch, tmp_path):
    """Variants whose source is the same text (an unchanged rect layer
    beside the parent's) share one library, built by one nvcc: two builds
    writing the same file at once left it cut short."""
    started = []

    class Proc:
        returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(tf._build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tf._build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(tf.subprocess, "Popen", lambda cmd, **kw: started.append(cmd) or Proc())
    monkeypatch.setattr(tf.ctypes, "CDLL", lambda path: path)
    libs = tf.build_variants({"this": {"text": "new", "rect": "same"},
                              "parent": {"text": "old", "rect": "same"}})
    assert len(started) == 3
    assert libs["this"]["rect"] == libs["parent"]["rect"]
    assert libs["this"]["text"] != libs["parent"]["text"]
