"""chip_smoke._k3_errors and _k3_ok: K3's (out, m, l) held to a reference
(the plain version, or with --old-rel-fwd an earlier K3) within the K3
limits: out within 2^-7 |ref| + OUT_REL_TOL max |ref| of each element, m
within K3_M_ABS_TOL, l within K3_L_REL_TOL of itself."""

import numpy as np
import pytest
import torch

import chip_smoke


def _ref(seed=0, B=2, H=3, q=5, Dh=8):
    rng = np.random.RandomState(seed)
    out = torch.from_numpy(rng.randn(B, q, H, Dh).astype(np.float32))
    m = torch.from_numpy(rng.randn(B, H, q).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 50, (B, H, q)).astype(np.float32))
    return out.to(torch.bfloat16), m, l


def test_k3_errors_of_identical_outputs_are_zero_and_ok():
    ref = _ref()
    e = chip_smoke._k3_errors(ref, ref)
    assert e["max_abs_err"] == 0 and e["m_abs_err"] == 0
    assert e["l_rel_err"] == 0 and e["err_over_limit_max"] < 0
    assert e["out_plain_absmax"] == float(ref[0].float().abs().max())
    assert chip_smoke._k3_ok(e)


def test_k3_one_bf16_ulp_of_each_element_is_within_the_limit():
    """Both sides round out to bf16: one ulp apart (2^-7 of the element
    at most) everywhere still passes."""
    out, m, l = _ref()
    bumped = (out.float() * (1 + 2.0 ** -8)).to(torch.bfloat16)
    assert not torch.equal(bumped, out)
    e = chip_smoke._k3_errors((bumped, m, l), (out, m, l))
    assert e["max_abs_err"] > 0 and chip_smoke._k3_ok(e)


@pytest.mark.parametrize("which", ["out", "m", "l", "nan"])
def test_k3_ok_fails_past_each_limit(which):
    out, m, l = _ref(1)
    got = [out.clone(), m.clone(), l.clone()]
    if which == "out":
        # one element moved by a tenth of the largest output
        got[0][0, 0, 0, 0] += 0.1 * out.float().abs().max().to(torch.bfloat16)
    elif which == "m":
        got[1][1, 2, 3] += 3 * chip_smoke.K3_M_ABS_TOL
    elif which == "l":
        got[2][0, 1, 4] *= 1 + 3 * chip_smoke.K3_L_REL_TOL
    else:
        got[1][0, 0, 0] = float("nan")
    assert not chip_smoke._k3_ok(chip_smoke._k3_errors(tuple(got),
                                                       (out, m, l)))
