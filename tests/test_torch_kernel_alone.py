"""chip_smoke.kernel_alone_ms: the kernel-alone ms per launch of K3, K4 and
K5, picked from a profile's device ms by kernel name and divided by the
launches in the profiled call."""

import pytest

import chip_smoke

# a train-step profile as _profile_busy returns it (names cut to 100
# characters, the anonymous namespace dropped)
PROFILE = {
    "k5_rel_bwd_dkv_kernel(Params)": 22.51,
    "k4_rel_bwd_dq_kernel(Params)": 12.96,
    "k3_rel_attention_kernel(Params)": 9.6,
    "k3_key_terms_kernel(Params)": 0.4,
    "prep_kernel(Params)": 1.5,
    "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor": 30.0,
}
LAUNCHES = {"flash_rel_attention": 48, "flash_rel_attention_bwd_dq": 48,
            "flash_rel_attention_bwd_dkv": 48, "flash_ring_decode": 0}


def test_kernel_alone_ms_per_launch():
    got = chip_smoke.kernel_alone_ms(PROFILE, LAUNCHES)
    assert got == pytest.approx({"flash_rel_attention": 9.6 / 48,
                                 "flash_rel_attention_bwd_dq": 12.96 / 48,
                                 "flash_rel_attention_bwd_dkv": 22.51 / 48})


def test_kernel_alone_ms_sums_entries_of_one_kernel():
    """Entries whose names both hold the kernel's (two signatures in one
    profile) are one kernel's time."""
    prof = dict(PROFILE, **{"k4_rel_bwd_dq_kernel(Params) [2]": 1.44})
    got = chip_smoke.kernel_alone_ms(prof, LAUNCHES)
    assert got["flash_rel_attention_bwd_dq"] == pytest.approx(14.4 / 48)


@pytest.mark.parametrize("drop", ["profile", "launches"])
def test_kernel_alone_ms_leaves_out_what_it_cannot_divide(drop):
    prof, launches = dict(PROFILE), dict(LAUNCHES)
    if drop == "profile":
        del prof["k4_rel_bwd_dq_kernel(Params)"]
    else:
        launches["flash_rel_attention_bwd_dq"] = 0
    got = chip_smoke.kernel_alone_ms(prof, launches)
    assert set(got) == {"flash_rel_attention", "flash_rel_attention_bwd_dkv"}
    assert chip_smoke.kernel_alone_ms({}, LAUNCHES) == {}
