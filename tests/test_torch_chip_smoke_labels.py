"""``chip_smoke.py``'s kernel labels, read from the mangled names that
``ptxas -v`` and ``cuobjdump -sass`` print: the build phase checks spills
and SASS by these labels. A kernel in an anonymous namespace carries that
namespace's hash, which changes with the source's path and can itself read
as a length and a name ending in ``_kernel``; the label is the last such
pair."""

import pytest

import chip_smoke


@pytest.mark.parametrize("mangled,label", [
    # the hash "...7807879820" before the name: both "66..." and "20..." read
    # as a length and a name ending in _kernel
    ("_ZN66ac71e_26_flash_attention_bwd_f32_cu_7807879820flash_bwd_f32_kernel"
     "ILi512ELb0EEEv14CUtensorMap_stS1_", "flash_bwd_f32_kernel<512,0>"),
    ("_ZN48_GLOBAL__N__016e1201_15_fused_resnet_cu_6679511e21conv3x3_dw_f32_kernel"
     "ILi16EEEv14CUtensorMap_stS1_Pfiiiii", "conv3x3_dw_f32_kernel<16>"),
    ("_ZN48_GLOBAL__N__016e1201_15_fused_resnet_cu_6679511e32fused_gn_silu_conv3x3_f32"
     "_kernelE14CUtensorMap_stS0_NS_12NchwEpilogueIfEEiiii", "fused_gn_silu_conv3x3_f32_kernel"),
    ("_ZN48_GLOBAL__N__cca_13_group_norm_cu_b1d77a3516gn_bwd_dx_kernelI13__nv_bfloat16Lb1EEvPKT_",
     "gn_bwd_dx_kernel<bf16,1>"),
    ("_Z10not_akernelv", "_Z10not_akernelv"),
])
def test_kernel_label_is_the_last_name_ending_in_kernel(mangled, label):
    assert chip_smoke.kernel_label(mangled) == label
