"""The side-by-side timing tool's source variants, on the CPU: cutting the
D = 64 score widths of the attention kernel touches only that dispatch."""
import re

import pytest

from rpo_tpu_torch.ops import _build
from rpo_tpu_torch.tools.time_attention import with_d64_widths

SOURCE = (_build.CSRC / "rect_attention.cu").read_text()


def _d64_case(source: str) -> str:
    start = source.index("    case 64:\n", source.index("int dispatch_bf16("))
    return source[start:source.index("    case 128:", start)]


def _widths(case: str):
    return [int(w) for w in re.findall(r"launch_tc<64, HAS_BIAS, (\d+)>", case)]


@pytest.mark.parametrize("widths", [[13, 16], [5, 13, 16], [16], [16, 2, 5, 13, 2]])
def test_d64_widths_change_only_that_dispatch(widths):
    out = with_d64_widths(SOURCE, widths)
    assert _widths(_d64_case(out)) == sorted(set(widths))
    # everything but the D = 64 case is the checkout's source
    assert out.replace(_d64_case(out), "") == SOURCE.replace(_d64_case(SOURCE), "")
    # a shape takes the narrowest width that holds its tiles
    for w in sorted(set(widths))[:-1]:
        assert f"nkt <= {w} ? launch_tc<64, HAS_BIAS, {w}>" in out


def test_d64_widths_of_the_checkout_are_its_own():
    assert _widths(_d64_case(with_d64_widths(SOURCE, _widths(_d64_case(SOURCE))))) == \
        _widths(_d64_case(SOURCE))


@pytest.mark.parametrize("widths", [[], [2, 5, 13], [0, 16], [13, 17]])
def test_d64_widths_must_hold_the_widest_row(widths):
    with pytest.raises(ValueError):
        with_d64_widths(SOURCE, widths)
