"""The MoE, hybrid, ssm, audio and vlm configs at their published size,
shapes only.

The reference's tree from ``jax.eval_shape`` of its init; the port's from
its own init run under ``FakeTensorMode`` (shapes and dtypes, no storage),
so neither allocates dbrx-132b's 132 billion parameters.  Leaf for leaf the
shapes and dtypes agree (the float32 router and SSM leaves among the bf16
ones; xlstm's list of 12 layer dicts, whisper's stacked encoder and
decoder blocks); stacked over ring(4) workers as meta tensors, the bucket
layout's leaf offsets are the reference's, ``path="auto"`` resolves as the
reference's does and the wire bytes a step are equal, Moniqua 8-bit and
D-PSGD.
"""
import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.comm import bucket as jbucket
from repro.configs import get_config as jget_config
from repro.core import algorithms as jalg
from repro.core.moniqua import MoniquaCodec as JCodec
from repro.core.quantizers import QuantSpec as JSpec
from repro.core.topology import ring as jring
from repro.models.model_factory import build_model as jbuild
from repro_torch import tree
from repro_torch.comm import bucket as tbucket
from repro_torch.configs import get_config as tget_config
from repro_torch.core import algorithms as talg
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.core.topology import ring as tring
from repro_torch.models.model_factory import build_model as tbuild

N = 4
# arch -> (leaves, whether float32 leaves sit among the bf16 ones)
ARCHS = {"dbrx-132b": (13, True), "grok-1-314b": (13, True),
         "zamba2-1.2b": (21, True), "xlstm-125m": (78, False),
         "whisper-base": (32, False), "phi-3-vision-4.2b": (13, False)}


def _port_leaves(cfg):
    """``(shape, dtype name)`` of each leaf of the port's init, in JAX's
    leaf order."""
    with FakeTensorMode():
        params = tbuild(cfg, device="cpu").init(torch.Generator())
        return [(tuple(a.shape), str(a.dtype).removeprefix("torch."))
                for a in tree.leaves(params)]


@pytest.mark.parametrize("arch", ARCHS)
def test_published_tree_shapes_auto_path_and_bytes(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    jl = [(a.shape, str(a.dtype)) for a in jax.tree.leaves(shapes)]
    n_leaves, mixed = ARCHS[arch]
    assert len(jl) == n_leaves
    assert _port_leaves(tcfg) == jl
    assert {d for _, d in jl} == ({"bfloat16", "float32"} if mixed
                                  else {"bfloat16"})
    assert sum(int(np.prod(s)) for s, _ in jl) >= 0.9 * jcfg.param_count()
    jX = jax.tree.map(lambda a: jax.ShapeDtypeStruct((N,) + a.shape,
                                                     a.dtype), shapes)
    tX = tree.map(lambda a: torch.empty((N,) + a.shape, device="meta",
                                        dtype=getattr(torch, str(a.dtype))),
                  shapes)
    spec = dict(bits=8, stochastic=True)
    jhp = jalg.AlgoHyper(topo=jring(N), codec=JCodec(JSpec(**spec)),
                         theta=2.0, backend="jnp")
    thp = talg.AlgoHyper(topo=tring(N), codec=TCodec(TSpec(**spec)),
                         theta=2.0)
    for align in (1, 8):
        assert tbucket.layout_of(tX, align).offsets == \
            jbucket.layout_of(jX, align).offsets
    assert thp.engine().resolved_path(tX) == jhp.engine().resolved_path(jX)
    for algo in ("moniqua", "dpsgd"):
        assert (talg.get_algorithm(algo).bytes_per_step(tX, thp)
                == jalg.get_algorithm(algo).bytes_per_step(jX, jhp))
