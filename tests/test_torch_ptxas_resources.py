"""chip_smoke.ptxas_resources: the registers, stack, spill bytes and static
shared memory of K3, K4, K5 and the two instances each of K1 and the prime
read from nvcc's ``-Xptxas -v`` output."""

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


RING_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__649069c0_20_flash_ring_decode_cu_f855b41815k2_prime_kernelI13__nv_bfloat16EEvPKT_S4_PKfS6_PKS1_S6_PfS9_S9_iiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__649069c0_20_flash_ring_decode_cu_f855b41815k2_prime_kernelI13__nv_bfloat16EEvPKT_S4_PKfS6_PKS1_S6_PfS9_S9_iiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 244 registers, used 1 barriers
ptxas info    : Compile time = 290.870 ms
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__649069c0_20_flash_ring_decode_cu_f855b41815k2_prime_kernelIaEEvPKT_S3_PKfS5_PK13__nv_bfloat16S5_PfS9_S9_iiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__649069c0_20_flash_ring_decode_cu_f855b41815k2_prime_kernelIaEEvPKT_S3_PKfS5_PK13__nv_bfloat16S5_PfS9_S9_iiiiiif
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__649069c0_20_flash_ring_decode_cu_f855b41816k1_decode_kernelI13__nv_bfloat16EEvPKT_S4_PKfS6_PKS1_S6_PfS9_S9_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__649069c0_20_flash_ring_decode_cu_f855b41816k1_decode_kernelI13__nv_bfloat16EEvPKT_S4_PKfS6_PKS1_S6_PfS9_S9_iiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 50 registers, used 0 barriers, 8192 bytes smem
"""


def test_ptxas_resources_reads_each_prime_instance():
    """The prime's two template instances (bf16 and int8 cache) are kept
    apart by their template argument; K1's instance beside them is read
    under its own name."""
    got = chip_smoke.ptxas_resources(RING_LOG)
    assert {k: got[k] for k in got if k.startswith("k2_")} == {
        "k2_prime_kernel<bf16>": {"registers": 244, "stack": 0,
                                  "spill_stores": 0, "spill_loads": 0,
                                  "smem": 0},
        "k2_prime_kernel<int8>": {"registers": 255, "stack": 8,
                                  "spill_stores": 4, "spill_loads": 4,
                                  "smem": 0},
    }
    assert set(got) == {"k2_prime_kernel<bf16>", "k2_prime_kernel<int8>",
                        "k1_decode_kernel<bf16>"}


K3_K1_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__ea2d10d2_22_flash_rel_attention_cu_2e11f57223k3_rel_attention_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__ea2d10d2_22_flash_rel_attention_cu_2e11f57223k3_rel_attention_kernelENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compile time = 637.754 ms
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__ea2d10d2_22_flash_rel_attention_cu_2e11f57219k3_key_terms_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__ea2d10d2_22_flash_rel_attention_cu_2e11f57219k3_key_terms_kernelENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__649069c0_20_flash_ring_decode_cu_f855b41816k1_decode_kernelI13__nv_bfloat16EEvPKT_S4_PKfS6_PKS1_S6_PfS9_S9_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__649069c0_20_flash_ring_decode_cu_f855b41816k1_decode_kernelI13__nv_bfloat16EEvPKT_S4_PKfS6_PKS1_S6_PfS9_S9_iiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 54 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__649069c0_20_flash_ring_decode_cu_f855b41816k1_decode_kernelIaEEvPKT_S3_PKfS5_PK13__nv_bfloat16S5_PfS9_S9_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__649069c0_20_flash_ring_decode_cu_f855b41816k1_decode_kernelIaEEvPKT_S3_PKfS5_PK13__nv_bfloat16S5_PfS9_S9_iiiif
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 8 bytes cumulative stack size
"""


def test_ptxas_resources_reads_k3_and_both_k1_instances():
    """K3's entry (not its key-terms kernel) and K1's two template
    instances, each under its own name."""
    assert chip_smoke.ptxas_resources(K3_K1_LOG) == {
        "k3_rel_attention_kernel": {"registers": 255, "stack": 0,
                                    "spill_stores": 0, "spill_loads": 0,
                                    "smem": 0},
        "k1_decode_kernel<bf16>": {"registers": 54, "stack": 0,
                                   "spill_stores": 0, "spill_loads": 0,
                                   "smem": 0},
        "k1_decode_kernel<int8>": {"registers": 72, "stack": 8,
                                   "spill_stores": 4, "spill_loads": 4,
                                   "smem": 0},
    }


SERIAL_LOG = K3_K1_LOG + """\
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to non wgmma instructions defining accumulator registers of a wgmma between start and end of the pipeline stage in the function '_ZN55_GLOBAL__N__ea2d10d2_22_flash_rel_attention_cu_2e11f57223k3_rel_attention_kernelENS_6ParamsE'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to the presence of Extern calls in the function '_ZN59_GLOBAL__N__c261b1c4_26_flash_rel_attention_bwd_cu_1922280020k4_rel_bwd_dq_kernelENS_6ParamsE'
"""


def test_wgmma_serialized_names_each_kernel_and_passes_a_clean_log():
    """ptxas's notes that it serialized a kernel's wgmma instructions (C7520
    and the same words under another code) are keyed by the kernel they
    name; a log without them gives nothing, so the build phase passes."""
    got = chip_smoke.wgmma_serialized(SERIAL_LOG)
    lines = SERIAL_LOG.splitlines()
    assert got == {"k3_rel_attention_kernel": [lines[-2]],
                   "k4_rel_bwd_dq_kernel": [lines[-1]]}
    assert chip_smoke.wgmma_serialized(K3_K1_LOG) == {}
    assert chip_smoke.wgmma_serialized(LOG + RING_LOG) == {}
    assert chip_smoke.wgmma_serialized(
        "ptxas info    : (C7520) wgmma pipeline split") == {
            "?": ["ptxas info    : (C7520) wgmma pipeline split"]}
