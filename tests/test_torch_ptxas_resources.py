"""chip_smoke.ptxas_resources: the registers, stack, spill bytes and static
shared memory of K4 and K5 read from nvcc's ``-Xptxas -v`` output."""

import chip_smoke

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN59_GLOBAL__N__c261b1c4_26_flash_rel_attention_bwd_cu_1922280021k5_rel_bwd_dkv_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN59_GLOBAL__N__c261b1c4_26_flash_rel_attention_bwd_cu_1922280021k5_rel_bwd_dkv_kernelENS_6ParamsE
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 232 registers, used 16 barriers
ptxas info    : Compile time = 488.378 ms
ptxas info    : Compiling entry function '_ZN59_GLOBAL__N__c261b1c4_26_flash_rel_attention_bwd_cu_1922280020k4_rel_bwd_dq_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN59_GLOBAL__N__c261b1c4_26_flash_rel_attention_bwd_cu_1922280020k4_rel_bwd_dq_kernelENS_6ParamsE
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 224 registers, used 1 barriers, 1024 bytes smem, 552 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN59_GLOBAL__N__c261b1c4_26_flash_rel_attention_bwd_cu_1922280016key_terms_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN59_GLOBAL__N__c261b1c4_26_flash_rel_attention_bwd_cu_1922280016key_terms_kernelENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, used 0 barriers
"""


def test_ptxas_resources_reads_k4_and_k5():
    got = chip_smoke.ptxas_resources(LOG)
    assert got == {
        "k5_rel_bwd_dkv_kernel": {"registers": 232, "stack": 0,
                                  "spill_stores": 8, "spill_loads": 12,
                                  "smem": 0},
        "k4_rel_bwd_dq_kernel": {"registers": 224, "stack": 16,
                                 "spill_stores": 0, "spill_loads": 0,
                                 "smem": 1024},
    }


def test_ptxas_resources_skips_other_kernels_and_empty_log():
    key_terms_only = LOG[LOG.index("ptxas info    : Compiling entry function "
                                   "'_ZN59_GLOBAL__N__c261b1c4_26_flash_rel_"
                                   "attention_bwd_cu_1922280016"):]
    assert chip_smoke.ptxas_resources(key_terms_only) == {}
    assert chip_smoke.ptxas_resources("") == {}
