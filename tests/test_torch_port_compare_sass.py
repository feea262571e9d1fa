"""The SASS comparison tool on the CPU: it reads cuobjdump's listing, drops
addresses and encodings, and pairs kernels by their instructions alone."""
import pytest

from rpo_tpu_torch.tools import compare_sass as cs

LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_119attention_kernel_tcILi64ELb0ELi13EEEvNS_6ParamsEixi
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
      /*0000*/      LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
      /* 0x000fe20000000800 */
      /*0010*/      @!P0 BRA 0x120 ;      /* 0x000000000000794d */
      /*0020*/      EXIT ;      /* 0x000000000000794d */
		..........

		Function : _ZN12_GLOBAL__N_116attention_kernelILi64ELb0EEEvNS_6ParamsE
      /*0000*/      MOV R2,  R3 ;      /* 0x00000a00ff017b82 */
"""


def test_parse_sass_keeps_the_instructions_of_each_kernel():
    got = cs.parse_sass(LISTING)
    assert list(got) == ["_ZN12_GLOBAL__N_119attention_kernel_tcILi64ELb0ELi13EEEvNS_6ParamsEixi",
                         "_ZN12_GLOBAL__N_116attention_kernelILi64ELb0EEEvNS_6ParamsE"]
    assert list(got.values()) == [("LDC R1, c[0x0][0x28]", "@!P0 BRA 0x120", "EXIT"),
                                  ("MOV R2, R3",)]


def test_pair_ignores_names_and_keeps_one_to_one():
    mine = {"a": ("X",), "b": ("Y", "Z"), "c": ("X",), "d": ("W",)}
    theirs = {"renamed a": ("X",), "renamed b": ("Y", "Z"), "e": ("V",)}
    paired, lone, lone_theirs = cs.pair(mine, theirs)
    assert paired == {"a": "renamed a", "b": "renamed b"}
    assert lone == ["c", "d"] and lone_theirs == ["e"]


@pytest.mark.parametrize("body,want", [
    (("A", "B", "C"), ("k1", 0)),
    (("A", "C"), ("k1", 1)),  # one deleted
    (("A", "X", "C", "D"), ("k1", 2)),  # one replaced, one inserted
    (("Q", "R"), ("k2", 1)),
])
def test_closest_counts_the_instructions_that_differ(body, want):
    assert cs.closest(body, {"k1": ("A", "B", "C"), "k2": ("Q",)}) == want
