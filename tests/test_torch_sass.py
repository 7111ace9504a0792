"""The SASS reader behind the scatter kernels' issue bound
(dssm_tpu_torch/tools/sass.py), on listings written out here in the two
forms cuobjdump prints branches in: absolute addresses and labels."""

import os
import re

import pytest

from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.tools import eval_kernels, sass

# Two kernels as cuobjdump lists them: encodings in comments, predicates,
# modifiers, uniform-datapath instructions, the NOPs and the branch to
# itself that end a listing.
LISTING = """
        Function : _ZN12_GLOBAL__N_117scatter_sr_kernelINS_4Int8EEEvPv
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;              /* 0x0000000000007919 */
        /*0020*/                   LDG.E.NA.128.CONSTANT R4, desc[UR4][R6.64] ;
        /*0030*/                   IMAD.WIDE.U32 R8, R9, -0x2daee0ad, RZ ;
        /*0040*/                   LOP3.LUT R10, R8, R11, R12, 0x96, !PT ;
        /*0050*/                   UIADD3 UR4, UR4, 0x800, URZ ;
        /*0060*/                   PRMT R3, R4, 0x7650, R5 ;
        /*0070*/                   FADD R13, R14, -12583040 ;
        /*0080*/                   FRND.FLOOR R16, R13 ;
        /*0090*/                   I2FP.F32.U32 R17, R18 ;
        /*00a0*/                   FSET.BF.GE.AND R19, R20, 1, PT ;
        /*00b0*/              @!P0 EXIT ;
        /*00c0*/                   STG.E desc[UR4][R6.64], R4 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0;
        /*00f0*/                   NOP;
        Function : _ZN12_GLOBAL__N_117scatter_sr_kernelINS_4Bf16EEEvPv
        /*0000*/                   FFMA R1, R2, R3, R4 ;
        /*0010*/               @P0 BRA `(.L_x_0) ;
.L_x_0:
        /*0020*/                   EXIT ;
"""


def test_counts_by_class():
    funcs = sass.functions(LISTING)
    assert len(funcs) == 2
    assert sass.counts(LISTING, "scatter_sr_kernel", "Int8") == {
        "all": 15, "int": 4, "fp32": 2, "conv": 1}
    assert sass.counts(LISTING, "Bf16") == {"all": 3, "int": 0, "fp32": 1,
                                            "conv": 0}


@pytest.mark.parametrize("parts", [("scatter_sr_kernel",), ("gather",)])
def test_counts_want_one_function(parts):
    with pytest.raises(ValueError):
        sass.counts(LISTING, *parts)


@pytest.mark.parametrize("per_element,clocks", [
    ({"all": 32.0, "int": 12.0, "fp32": 8.0, "conv": 1.0}, 0.25),
    ({"all": 16.0, "int": 20.0, "fp32": 2.0, "conv": 1.0}, 20 / 64),
    ({"all": 16.0, "int": 4.0, "fp32": 2.0, "conv": 6.0}, 6 / 16)])
def test_issue_bound_takes_the_slowest_class(per_element, clocks):
    # 132 SMs at 1 GHz, 132e6 elements: clocks an element x 1e6 clocks.
    us = sass.issue_bound_us(per_element, 132_000_000, 132, 1e9)
    assert us == pytest.approx(clocks * 1e3)


def test_scatter_kernel_names_and_elements_are_the_source_s():
    with open(os.path.join(_build.CSRC, "scatter_sr.cu")) as f:
        src = f.read()
    for name, parts in eval_kernels.SR_KERNELS.items():
        assert all(p in src for p in parts)
        op = re.search(r"struct " + parts[1] + r" \{.*?kUnits = (\d+);", src,
                       re.S)
        assert eval_kernels.SR_THREAD_ELEMENTS[name] == 4 * int(op.group(1))
    assert set(eval_kernels.SR_KERNELS) <= set(_build.KERNELS)


def test_scatter_bound_is_the_larger_of_bytes_and_issue():
    per_element = {"all": 30.0, "int": 15.0, "fp32": 8.0, "conv": 2.0}
    # 27 real slots of 32 x 384 int8 elements, 256 slots: 1.99 MB.
    bound, by, by_bytes, by_issue = eval_kernels.sr_bound_us(
        per_element, 27, 256, 32 * 384, 1, 132, 1.98e9)
    assert by_bytes == pytest.approx((27 * 32 * 384 * 6 + 1024) / 3.35e6)
    assert by == "bytes" and bound == by_bytes > by_issue
    bound, by, _, by_issue = eval_kernels.sr_bound_us(
        {"all": 3000.0}, 27, 256, 32 * 384, 1, 132, 1.98e9)
    assert by == "operations" and bound == by_issue
