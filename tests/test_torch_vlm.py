"""The vlm family (the phi-3-mini decoder over projected patch embeddings:
phi-3-vision-4.2b) in the port against the JAX package.

phi-3-vision-4.2b at the reference's reduced size (2 layers, d 256, 4
heads of 64, d_ff 512, vocab 512; 16 patch embeddings of 64, the CLIP
tower a stub in both packages) with 32 text tokens.  Weights from the
reference's init, carried across with ``repro_torch.convert``; inputs are
numpy draws handed to both.

Tolerances (``tests/test_torch_llama.py``'s): hidden states within 1e-5 x
max, logits within 1e-4 x max|logit| in float32 and 3e-2 in bfloat16, the
loss within ``rtol=1e-5``; losses, gradients and one Moniqua step as
``tests/torch_family_cases.py`` states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JShape
from repro.models import vlm as JVLM
from repro_torch import tree
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import InputShape as TShape
from repro_torch.models import transformer as TT
from repro_torch.models import vlm as TVLM
from torch_family_cases import one_thread  # noqa: F401 (autouse fixture)
from torch_family_cases import (check_batch_spec, check_loss_and_grads,
                                check_moniqua_step, check_trainer_bytes,
                                models, rel, tokens)

ARCH = "phi-3-vision-4.2b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, TEXT = 2, 32


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(tget_config(ARCH).reduced(), dtype=dtype))


def _models(dtype="float32"):
    return models(*_cfgs(dtype))


def _batch(cfg, lead=(B,), seed=0, labels=False):
    """Text tokens and patch embeddings ``[*lead, ...]`` (numpy)."""
    rng = np.random.default_rng(seed)
    toks = tokens(cfg.vocab_size, (*lead, TEXT + 1), seed=seed)
    b = {"tokens": toks[..., :-1].copy(),
         "patch_embeds": rng.standard_normal(
             (*lead, cfg.vision_tokens, cfg.vision_embed_dim)
         ).astype(np.float32)}
    if labels:
        b["labels"] = toks[..., 1:].copy()
    return b


def test_reduced_config_and_tree():
    """16 patches of 64 before 32 text tokens; the dense LM's tree and the
    projector ``[vision_embed_dim, d_model]``: 13 leaves."""
    _, tcfg = _cfgs()
    assert (tcfg.family, tcfg.vision_tokens, tcfg.vision_embed_dim) == \
        ("vlm", 16, 64)
    tm = _models()[1]
    p = tm.init(tm.generator(0))
    assert tuple(p["projector"].shape) == (64, tcfg.d_model)
    assert len(tree.leaves(p)) == 13


def test_hidden_and_loss_match_reference():
    """``vlm_hidden`` over ``[patches | text]`` at positions ``0 .. 47``,
    and ``vlm_loss`` over the text positions only: it equals the
    cross-entropy of prefill's text logits."""
    jm, tm, params, tp = _models()
    b = _batch(tm.cfg, labels=True)
    jb = jax.tree.map(jnp.asarray, b)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    hj, _ = jax.jit(lambda p, t, e: JVLM.vlm_hidden(p, jm.cfg, t, e))(
        params, jb["tokens"], jb["patch_embeds"])
    ht, aux = TVLM.vlm_hidden(tp, tm.cfg, tb["tokens"], tb["patch_embeds"])
    assert tuple(ht.shape) == (B, 16 + TEXT, tm.cfg.d_model)
    assert float(aux) == 0.0
    assert rel(ht, hj) <= 1e-5
    lj = jax.jit(jm.loss)(params, jb)
    lt = tm.loss(tp, tb)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    text = tm.prefill_logits(tp, tb)[:, 16:]
    np.testing.assert_allclose(float(TT.xent(text, tb["labels"],
                                             tm.cfg.vocab_size)),
                               float(lt), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits over ``[patches | text]`` (all positions and
    ``last_only``), then 8 decode steps from an empty cache (the dense
    LM's path): logits, ``pos`` and the cache."""
    jm, tm, params, tp = _models(dtype)
    b = _batch(tm.cfg)
    jb = {"tokens": jnp.asarray(b["tokens"]),
          "patch_embeds": jnp.asarray(b["patch_embeds"]).astype(
              jnp.dtype(dtype))}
    tb = {"tokens": torch.from_numpy(b["tokens"]),
          "patch_embeds": torch.from_numpy(b["patch_embeds"]).to(
              getattr(torch, dtype))}
    ref = np.asarray(jax.jit(jm.prefill_logits)(params, jb))
    for last_only in (False, True):
        got = tm.prefill_logits(tp, tb, last_only=last_only)
        assert got.dtype == torch.float32
        assert rel(got, ref[:, -1:] if last_only else ref) <= TOL[dtype]
    jc = jm.init_cache(B, JShape("d", 16, B, "decode"))
    tc = tm.init_cache(B, TShape("d", 16, B, "decode"))
    jdecode = jax.jit(jm.decode_step)
    dec = tokens(tm.cfg.vocab_size, (B, 8), seed=1)
    for s in range(8):
        jl, jc = jdecode(params, jc, jnp.asarray(dec[:, s:s + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(dec[:, s:s + 1]))
        assert rel(tl, jl) <= TOL[dtype]
        assert int(jc["pos"]) == int(tc["pos"]) == s + 1
    for name in ("k", "v"):
        assert rel(tc["layers"][name], jc["layers"][name]) <= TOL[dtype]


def test_batch_spec_matches_reference():
    jm, tm, _, _ = _models()
    check_batch_spec(jm, tm, 2048, 4)
    check_batch_spec(jm, tm, 20, 2)            # text floored at 8 tokens


def test_per_worker_loss_and_grads_match_reference():
    """Two workers' losses and gradients (``vmap(grad)``, the flash route)
    against the reference's; the projector's gradient included."""
    jm, tm, params, _ = _models()
    check_loss_and_grads(jm, tm, params, _batch(tm.cfg, (2, 1), 2, True))


def test_moniqua_train_step_matches_reference():
    jm, tm, params, _ = _models()
    check_moniqua_step(jm, tm, params, _batch(tm.cfg, (2, 1), 5, True))


def test_trainer_on_vlm_matches_reference_bytes():
    """``Trainer(model, tc, shape)`` on the reduced config in bf16, as
    published (``patch_embeds`` drawn by the pipeline): bytes per step
    equal the reference ``Trainer``'s."""
    check_trainer_bytes(*_cfgs("bfloat16"), ("tiny", 48, 4, "train"))
