"""The port's depth-probe calibration (``repro_torch.launch.calibrate``).

``_extrapolate`` on the reference's cases and against the reference's own
function, ``SCANNED_FAMILIES`` against the reference's (both read from its
source: importing ``repro.launch.calibrate`` would set ``XLA_FLAGS``), the
rows' statuses, and the check calibration makes here: for a homogeneous
stack, depth 1 and 2 extrapolated to depth 4 equal the dry run's direct
count at depth 4.
"""
import dataclasses

import pytest
import torch

from repro.configs import assigned_archs as j_assigned
from repro.configs import get_config as jget_config
from repro_torch.configs import assigned_archs, get_config
from repro_torch.launch import calibrate as CAL
from repro_torch.launch import dryrun as DR
from torch_launch_ref import ref_defs

torch.set_num_threads(1)

REF = ref_defs("calibrate", ("_extrapolate", "SCANNED_FAMILIES"))


def test_extrapolate_linear():
    # cost(L) = a + b L with probes at L=1,2
    a, b = 5.0, 3.0
    c1, c2 = a + b, a + 2 * b
    for L in (1, 2, 6, 48, 80):
        assert CAL._extrapolate(c1, c2, L) == pytest.approx(a + b * L)


def test_extrapolate_never_negative():
    assert CAL._extrapolate(10.0, 4.0, 100) == 0.0


@pytest.mark.parametrize("c1,c2,L", [(8.0, 11.0, 1), (8.0, 11.0, 80),
                                     (10.0, 4.0, 100), (2.5e13, 4.1e13, 28),
                                     (7.0, 7.0, 40), (0.0, 0.0, 3)])
def test_extrapolate_equals_the_reference(c1, c2, L):
    assert CAL._extrapolate(c1, c2, L) == REF["_extrapolate"](c1, c2, L)


def test_scanned_families_equal_the_reference():
    assert CAL.SCANNED_FAMILIES == REF["SCANNED_FAMILIES"]
    fams = {get_config(a).family for a in assigned_archs()}
    assert fams - set(CAL.SCANNED_FAMILIES) == {"ssm", "hybrid"}
    assert fams == {jget_config(a).family for a in j_assigned()}


def test_rows_not_scanned_and_skipped():
    for arch in ("xlstm-125m", "zamba2-1.2b"):
        assert CAL.calibrate_one(arch, "train_4k")["status"] == "not-scanned"
    row = CAL.calibrate_one("whisper-base", "long_500k")
    assert row == {"arch": "whisper-base", "shape": "long_500k",
                   "mesh": DR.MESH, "status": "skipped"}


@pytest.mark.parametrize("arch,shape", [("llama3.2-3b", "train_4k"),
                                        ("llama3.2-3b", "decode_32k"),
                                        ("whisper-base", "train_4k")])
def test_extrapolation_equals_the_direct_count(arch, shape):
    """A reduced stack at depth 4: calibrated from depth 1 and 2, equal to
    the dry run's count of all four layers in FLOPs, wire bytes and model
    FLOPs.  Bytes accessed are linear in depth only when serving: in
    training, autograd's backward of each layer's slice of the stacked
    block parameters writes a zero-filled gradient of the whole stack, so
    the bytes grow by a constant second difference (read off depth 3)."""
    def over(L):
        o = dict(DR.REDUCED, num_layers=L)
        if get_config(arch).family == "audio":
            o["encoder_layers"] = L
        return o

    row = CAL.calibrate_one(arch, shape, override=over(4))
    assert row["status"] == "ok", row.get("error")
    assert row["probe"]["num_layers"] == 4
    direct = {L: DR.dryrun_one(arch, shape, override=over(L), verbose=False)
              for L in (3, 4)}
    assert all(r.status == "ok" for r in direct.values())
    cal, d4 = row["roofline_calibrated"], direct[4].roofline
    for key in ("flops_per_chip", "collective_bytes_per_chip",
                "model_flops"):
        assert cal[key] == d4[key], key
    assert row["collectives_calibrated"]["bytes"] == {
        k: float(v) for k, v in direct[4].collectives["bytes"].items()}
    assert set(cal) == set(d4)
    b1, b2 = row["probe"]["L1"]["bytes"], row["probe"]["L2"]["bytes"]
    second = direct[3].roofline["bytes_per_chip"] - 2 * b2 + b1
    assert d4["bytes_per_chip"] == cal["bytes_per_chip"] + 3 * second
    assert (second > 0) == (shape == "train_4k")
