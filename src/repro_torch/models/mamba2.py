"""Mamba2 / SSD block (arXiv:2405.21060 formulation), chunkwise.

The counterpart of the reference's ``repro.models.mamba2``.  State-space
recurrence per head:

    h_t = exp(dt_t * A_h) h_{t-1} + dt_t * x_t B_t^T        h: [hd, N]
    y_t = h_t C_t + D_h x_t

computed by the chunked algorithm: within a chunk a quadratic
(length-c x length-c) product, across chunks a recurrence on the chunk
states.  The reference scans the chunk states with ``lax.scan``; here it is
a Python loop over the ``S / chunk`` chunks, accumulating out of place.
Every cast follows the reference's: the intra-chunk weights ``aw``, the
boundary weights ``wS`` and the decay ``wq`` are cast to ``x``'s dtype, the
chunk states and the carry live in ``x``'s dtype, ``dt`` is float32.

One difference in form: the intra-chunk decay ``exp(cums_t - cums_s)`` is
taken of ``-inf`` above the diagonal instead of being taken of the
(positive, there) exponent and masked after.  The forward is the same
(both give 0 there), but a masked ``exp`` that overflows (a chunk of 128
with ``dt * A`` near -1 a step) gives the reference's gradient ``0 * inf =
nan``; this form keeps it finite.

Block wiring (simplified Mamba2): three input projections (z gate,
x|B|C, dt heads), causal depthwise conv of width w on [x, B, C], silu,
SSD, the gate ``silu(z)``, out projection.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def dims(cfg):
    d = cfg.d_model
    di = cfg.ssm.expand * d
    nh = cfg.num_heads
    hd = di // nh
    ns = cfg.ssm.state_dim
    return d, di, nh, hd, ns


def init_mamba(gen, cfg, stack=()):
    """One block's weights (``[*stack, ...]`` for a layer stack): the
    reference's three separate input projections, its float32 ``a_log``
    (0: A = -1), ``d_skip`` (1) and ``dt_bias`` (0)."""
    d, di, nh, hd, ns = dims(cfg)
    dt = getattr(torch, cfg.dtype)
    dev = gen.device
    K = cfg.ssm.conv_width
    conv = torch.randn((*stack, K, di + 2 * ns), generator=gen, device=dev,
                       dtype=torch.float32)
    return {
        "ln": torch.ones((*stack, d), dtype=dt, device=dev),
        "w_z": L.dense_init(gen, d, di, dt, stack=stack),
        "w_xbc": L.dense_init(gen, d, di + 2 * ns, dt, stack=stack),
        "w_dt": L.dense_init(gen, d, nh, dt, stack=stack),
        "conv": conv.div_(math.sqrt(K)).to(dt),
        "a_log": torch.zeros((*stack, nh), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((*stack, nh), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((*stack, nh), dtype=torch.float32,
                               device=dev),
        "w_out": L.dense_init(gen, di, d, dt, scale=1.0 / math.sqrt(di),
                              stack=stack),
    }


def mamba_pspecs():
    return {"ln": (None,), "w_z": ("embed", "ssm_inner"),
            "w_xbc": ("embed", "ssm_inner"), "w_dt": ("embed", None),
            "conv": (None, None),
            "a_log": (None,), "d_skip": (None,), "dt_bias": (None,),
            "w_out": ("ssm_inner", "embed")}


def _causal_conv(u, w, state=None):
    """Depthwise causal conv.  u: [B, S, C]; w: [K, C]; state: [B, K-1, C]
    or None (zeros).  Returns (out [B, S, C], new_state [B, K-1, C])."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], K - 1, u.shape[-1]), dtype=u.dtype,
                            device=u.device)
    up = torch.cat([state, u], dim=1)
    S = u.shape[1]
    out = torch.zeros_like(u)
    for k in range(K):
        out = out + up[:, k:k + S] * w[k]
    return out, (up[:, -(K - 1):] if K > 1 else state)


def _ssd_chunked(x, dtv, A, Bm, Cm, chunk):
    """x: [B, S, H, D]; dtv: [B, S, H] (> 0, float32); A: [H] (< 0);
    Bm, Cm: [B, S, N].  Returns (y [B, S, H, D], final_state [B, H, D, N])."""
    Bsz, S, H, D = x.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    assert S % c == 0
    nc = S // c
    xr = x.reshape(Bsz, nc, c, H, D)
    dtr = dtv.reshape(Bsz, nc, c, H)
    Br = Bm.reshape(Bsz, nc, c, N)
    Cr = Cm.reshape(Bsz, nc, c, N)

    dA = dtr * A                                    # [B, nc, c, H] (< 0)
    cums = torch.cumsum(dA, dim=2)
    tot = cums[:, :, -1, :]

    # intra-chunk: y[t] += sum_{s<=t} exp(cums_t - cums_s) dt_s (C_t.B_s) x_s
    expo = cums[:, :, :, None, :] - cums[:, :, None, :, :]   # [B,nc,t,s,H]
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    w = torch.exp(expo.masked_fill(~tri[:, :, None], -math.inf))
    cb = torch.einsum("bntk,bnsk->bnts", Cr, Br)               # [B,nc,t,s]
    aw = (w * cb[..., None] * dtr[:, :, None, :, :]).to(x.dtype)
    y_intra = torch.einsum("bntsh,bnshd->bnthd", aw, xr)

    # chunk boundary states: S_n = sum_s exp(tot - cums_s) dt_s x_s B_s^T
    wS = (torch.exp(tot[:, :, None, :] - cums) * dtr).to(x.dtype)
    Sn = torch.einsum("bnshd,bnsk->bnhdk", xr * wS[..., None], Br)

    # the recurrence over chunks (the reference's lax.scan), out of place
    decay = torch.exp(tot)                          # [B, nc, H] float32
    h = torch.zeros_like(Sn[:, 0])
    hprevs = []
    for i in range(nc):
        hprevs.append(h)
        h = h * decay[:, i, :, None, None].to(h.dtype) + Sn[:, i]
    hprev = torch.stack(hprevs, dim=1)              # [B, nc, H, D, N]

    wq = torch.exp(cums).to(x.dtype)                # decay from chunk start
    y_inter = torch.einsum("bntk,bnhdk->bnthd", Cr, hprev) * wq[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, D)
    return y, h


def _inputs(p, x):
    """The block's norm and three input projections."""
    xin = L.rms_norm(x, p["ln"])
    return xin @ p["w_z"], xin @ p["w_xbc"], xin @ p["w_dt"]


def mamba_block(p, cfg, x):
    """x: [B, S, d] -> [B, S, d] (residual added)."""
    d, di, nh, hd, ns = dims(cfg)
    B, S, _ = x.shape
    z, xbc, dtp = _inputs(p, x)
    conv_out, _ = _causal_conv(xbc, p["conv"])
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :di].reshape(B, S, nh, hd)
    Bm = conv_out[..., di:di + ns]
    Cm = conv_out[..., di + ns:]
    dtv = F.softplus(dtp.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    y, _ = _ssd_chunked(xs, dtv, A, Bm, Cm, cfg.ssm.chunk)
    y = y + xs * p["d_skip"][None, None, :, None].to(xs.dtype)
    y = y.reshape(B, S, di) * F.silu(z)
    return x + y @ p["w_out"]


def mamba_decode(p, cfg, x, state):
    """Single-token step.  x: [B, 1, d]; state {"h": [B, H, D, N], "conv":
    [B, K-1, C]}.  Returns (x + y, the new state), new tensors."""
    d, di, nh, hd, ns = dims(cfg)
    B = x.shape[0]
    z, xbc, dtp = _inputs(p, x[:, 0])
    conv_out, conv_state = _causal_conv(xbc[:, None, :], p["conv"],
                                        state["conv"])
    conv_out = F.silu(conv_out[:, 0])
    xs = conv_out[..., :di].reshape(B, nh, hd)
    Bm = conv_out[..., di:di + ns]
    Cm = conv_out[..., di + ns:]
    dtv = F.softplus(dtp.float() + p["dt_bias"])                    # [B, H]
    A = -torch.exp(p["a_log"])
    dA = torch.exp(dtv * A)                                         # [B, H]
    hs = state["h"]
    h = (hs * dA[:, :, None, None].to(hs.dtype)
         + dtv.to(xs.dtype)[:, :, None, None] * xs[..., None]
         * Bm[:, None, None, :])
    y = (torch.einsum("bhdk,bk->bhd", h, Cm)
         + xs * p["d_skip"][None, :, None].to(xs.dtype))
    y = y.reshape(B, 1, di) * F.silu(z)[:, None]
    return x + y @ p["w_out"], {"h": h, "conv": conv_state}


def init_mamba_state(batch, cfg, device, stack=()):
    d, di, nh, hd, ns = dims(cfg)
    dt = getattr(torch, cfg.dtype)
    dev = torch.device(device)
    return {"h": torch.zeros((*stack, batch, nh, hd, ns), dtype=dt,
                             device=dev),
            "conv": torch.zeros((*stack, batch, cfg.ssm.conv_width - 1,
                                 di + 2 * ns), dtype=dt, device=dev)}
