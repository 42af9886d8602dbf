"""The port's roofline module against the JAX package's, on the CPU.

``model_flops_for`` for every registered config and shape; the
``Roofline`` terms and properties, given the reference's ``HW`` table; the
link override; and the gossip round's collectives, whose bytes must be the
engine's ``bytes_per_round`` (and the reference engine's, on the same
tree's shapes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as JRL
from repro.comm.engine import CommEngine as JEngine
from repro.comm.engine import make_wire as jmake_wire
from repro.configs import ARCH_MODULES
from repro.configs import get_config as jget_config
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.core import topology as JT
from repro.core.quantizers import QuantSpec as JSpec
from repro.sim.network import LinkModel as JLink
from repro_torch.analysis import roofline as TRL
from repro_torch.comm.engine import CommEngine as TEngine
from repro_torch.comm.engine import make_wire as tmake_wire
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import INPUT_SHAPES as T_SHAPES
from repro_torch.core import topology as TT
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.sim.network import LinkModel as TLink


@pytest.mark.parametrize("arch", list(ARCH_MODULES))
def test_model_flops_for_matches_reference(arch):
    for name in J_SHAPES:
        assert TRL.model_flops_for(tget_config(arch), T_SHAPES[name]) == \
            JRL.model_flops_for(jget_config(arch), J_SHAPES[name])


class _Compiled:
    """What ``roofline_from_compiled`` reads of a compiled step: its cost
    analysis and an HLO text with no collective."""

    def __init__(self, flops, nbytes):
        self.ca = {"flops": flops, "bytes accessed": nbytes}

    def cost_analysis(self):
        return self.ca

    def as_text(self):
        return ""


@pytest.mark.parametrize("flops,nbytes,model_flops,chips", [
    (3.2e15, 1.1e12, 2.5e15, 1), (1e9, 9e12, 5e8, 1), (7e14, 2e11, 9e14, 4)])
def test_roofline_matches_reference_given_its_hw(monkeypatch, flops, nbytes,
                                                 model_flops, chips):
    """The same counts priced on the reference's HW table: every field
    and property of the reference's ``roofline_from_compiled``."""
    monkeypatch.setitem(TRL.HW, "peak_flops", JRL.HW["peak_flops"])
    ref = JRL.roofline_from_compiled(_Compiled(flops, nbytes), model_flops,
                                     chips, hw=JRL.HW)
    got = TRL.roofline_from_counts(flops, nbytes, 0.0, model_flops, chips,
                                   hw=dict(JRL.HW))
    for f in ("flops", "bytes_accessed", "collective_bytes", "compute_s",
              "memory_s", "collective_s", "model_flops", "chips",
              "dominant", "bound_s", "useful_ratio", "mfu_upper_bound"):
        assert getattr(got, f) == getattr(ref, f), f
    # with a collective term, against the reference's own arithmetic
    r = TRL.roofline_from_counts(flops, nbytes, 1e13, model_flops, chips,
                                 hw=dict(JRL.HW))
    j = JRL.Roofline(flops, nbytes, 1e13, flops / JRL.HW["peak_flops"],
                     nbytes / JRL.HW["hbm_bw"], 1e13 / JRL.HW["ici_bw"],
                     model_flops, chips)
    for f in ("dominant", "bound_s", "useful_ratio", "mfu_upper_bound"):
        assert getattr(r, f) == getattr(j, f), f


def test_hw_is_the_h100_data_sheet():
    assert TRL.HW["peak_flops"] == 989e12 and TRL.HW["hbm_bw"] == 3.35e12
    assert TRL.HW["ici_bw"] == TRL.HW["hbm_bw"] / 2


@pytest.mark.parametrize("bad", [0.0, -1.0, 0])
def test_hw_with_ici_raises_as_the_reference(bad):
    for mod in (JRL, TRL):
        with pytest.raises(ValueError):
            mod.hw_with_ici(bad)


def test_hw_with_ici_takes_a_link_model_or_a_float():
    assert TRL.hw_with_ici(TLink(1e-6, 2.5e10))["ici_bw"] == \
        JRL.hw_with_ici(JLink(1e-6, 2.5e10))["ici_bw"] == 2.5e10
    assert TRL.hw_with_ici(5e9) == dict(TRL.HW, ici_bw=5e9)
    assert TRL.hw_with_ici(TLink(0.0, 1e9))["peak_flops"] == \
        TRL.HW["peak_flops"]


_SHAPES = {"w": (33, 70), "b": (70,), "emb": (300, 16), "s": (5,)}


def _trees(n, dtypes=None):
    dtypes = dtypes or {}
    t = {k: torch.empty((n,) + s, dtype=getattr(torch, dtypes.get(k,
                                                                "float32")),
                        device="meta") for k, s in _SHAPES.items()}
    j = {k: jax.ShapeDtypeStruct((n,) + s, getattr(jnp, dtypes.get(
        k, "float32"))) for k, s in _SHAPES.items()}
    return t, j


@pytest.mark.parametrize("tiers", [1, 4])
@pytest.mark.parametrize("wire,bits", [("moniqua", 8), ("moniqua", 1),
                                       ("qsgd", 8), ("ef_qsgd", 4),
                                       ("onebit", 1), ("full", 32)])
@pytest.mark.parametrize("path,chunks", [("bucketed", 1), ("bucketed", 3),
                                         ("per_leaf", 1), ("auto", 1)])
def test_collectives_of_bytes_are_bytes_per_round(tiers, wire, bits, path,
                                                  chunks):
    n = 8
    X, XJ = _trees(n, {"emb": "bfloat16"} if wire == "moniqua" else None)
    stoch = bits > 1
    if tiers == 1:
        ttopo, jtopo = TT.ring(n), JT.ring(n)
    else:
        ttopo, jtopo = TT.two_tier(n, tiers), JT.two_tier(n, tiers)
    eng = TEngine(ttopo, tmake_wire(wire, TSpec(bits, stoch)), path=path,
                  chunks=chunks)
    jeng = JEngine(jtopo, jmake_wire(wire, JSpec(bits, stoch)), "jnp",
                   path=path, chunks=chunks)
    st = TRL.collectives_of(eng, X)
    assert st.total_bytes == eng.bytes_per_round(X) == \
        jeng.bytes_per_round(XJ)
    offsets = eng.gossip_topo.neighbor_offsets()
    permutes = {f"collective-permute[{o:+d}]" for o in offsets}
    assert permutes <= set(st.counts)
    assert len({st.counts[p] for p in permutes}) == 1
    assert all(st.bytes_by_op[p] == eng.payload_bytes_per_broadcast(X)
               for p in permutes)
    if tiers > 1:
        assert st.counts["all-gather"] == st.counts["reduce-scatter"] == 1
        assert (st.bytes_by_op["all-gather"]
                + st.bytes_by_op["reduce-scatter"]
                == eng.fast_bytes_per_round(X))
    else:
        assert set(st.counts) == permutes
    assert st.summary() != "none"


def test_collectives_of_counts_the_rolls_of_a_round():
    """One roll of the codes a chunk (bucketed) or a leaf (per-leaf) toward
    each neighbor; qsgd ships a scale beside them.  Counted by patching the
    engine's roll."""
    from repro_torch.comm import gossip
    n = 8
    rng = np.random.default_rng(0)
    X = {k: torch.from_numpy(rng.standard_normal((n,) + s).astype(
        np.float32)) for k, s in _SHAPES.items()}
    for wire, bits, path, chunks in (("moniqua", 8, "bucketed", 1),
                                     ("moniqua", 8, "bucketed", 3),
                                     ("moniqua", 8, "per_leaf", 1),
                                     ("qsgd", 8, "bucketed", 2)):
        eng = TEngine(TT.ring(n), tmake_wire(wire, TSpec(bits, True)),
                      path=path, chunks=chunks)
        rolls = []
        orig = gossip._roll

        def spy(x, o):
            if x.dtype == torch.uint8 or (wire == "qsgd"
                                          and x.dtype == torch.float32):
                rolls.append(o)
            return orig(x, o)
        gossip._roll = spy
        try:
            eng.mix(X, theta=2.0, seed=3)
        finally:
            gossip._roll = orig
        st = TRL.collectives_of(eng, X)
        for o in (-1, 1):
            assert st.counts[f"collective-permute[{o:+d}]"] == \
                rolls.count(o), (wire, path, chunks)
